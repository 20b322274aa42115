"""The two-pass fuzzy kernels B7 (`fuzzy_normalizer`) and B8
(`fuzzy_accumulate`) of the port against the JAX package, on the CPU.

The same seeded numpy inputs go to both packages. The JAX side runs its
Pallas kernels in interpret mode (automatic off-TPU) with their default
blocks, which pad N, K and d and mask or correct the padding. On the
port's side, CPU tensors take the plain PyTorch versions.

Tolerances (float32, different summation order in the two frameworks):
s rtol 1e-6; Σμ and J_m rtol 1e-5; Σμx within 1e-5 of Σμ|x| per entry.
The centroids are drawn apart from the points: at a centroid that sits on
a point, the expanded d² = ‖x‖² + ‖c‖² − 2x·c is rounding noise in both
packages and s is dominated by its inverse, so no tolerance holds there.
bf16 rows go to both as bf16 (the port reads ml_dtypes' bfloat16 numpy
arrays as they are); both round the centroids to bf16 before ‖c‖².
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tdc_tpu.ops import pallas_kernels as jpk
from tdc_tpu_torch.ops import fuzzy_kernels as tfk

S_RTOL = 1e-6
RTOL = 1e-5
MS = [2.0, 1.7]
SHAPES = {"ragged": (300, 37, 19), "even": (256, 64, 8)}
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _case(shape, dtype="f32", seed=0):
    n, k, d = SHAPES[shape]
    rng = np.random.default_rng(seed + sum(map(ord, shape)))
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(scale=1.5, size=(k, d)).astype(np.float32)
    return x.astype(DTYPES[dtype]), c


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _rounded(x, c):
    """The centroids as both kernels see them: rounded to the rows'
    dtype."""
    return c.astype(x.dtype).astype(np.float32)


def _abs_sums(x, c, s, m):
    """Σμ|x| per (cluster, feature) from the JAX normaliser, f64."""
    xf = x.astype(np.float64)
    cf = _rounded(x, c).astype(np.float64)
    d2 = np.maximum((xf * xf).sum(1)[:, None] + (cf * cf).sum(1)[None]
                    - 2 * xf @ cf.T, 0)
    mu = ((d2 + 1e-9) ** (-1 / (m - 1)) / s[:, None]) ** m
    return mu.T @ np.abs(xf)


def _assert_stats(got, want, scale):
    np.testing.assert_allclose(got.weighted_sums.numpy(),
                               np.asarray(want.weighted_sums), rtol=0,
                               atol=1e-5 * float(scale.max()))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=RTOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_b7_b8_and_twopass_against_interpret_mode(shape, m, dtype):
    x, c = _case(shape, dtype)
    s_want = np.asarray(jpk.fuzzy_normalizer(x, c, m)).reshape(-1)
    s = tfk.fuzzy_normalizer(_t(x), _t(c), m)
    assert s.shape == (x.shape[0],) and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), s_want, rtol=S_RTOL)
    np.testing.assert_allclose(
        tfk.fuzzy_normalizer_plain(_t(x).float(), _t(_rounded(x, c)), m)
        .numpy(), s_want, rtol=S_RTOL)
    scale = _abs_sums(x, c, s_want, m)
    want = jpk.fuzzy_accumulate(x, c, s_want[:, None], m)
    _assert_stats(tfk.fuzzy_accumulate(_t(x), _t(c), s, m), want, scale)
    _assert_stats(tfk.fuzzy_stats_twopass(_t(x), _t(c), m),
                  jpk.fuzzy_stats_twopass(x, c, m), scale)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("m", MS)
def test_shard_identity(parts, m):
    """s summed over contiguous K-blocks equals s over all K, and B8 on
    each block with that s, concatenated, equals B8 (and B6) on all K:
    the K-sharded tower's identity."""
    x, c = _case("ragged", seed=1)
    xt, ct = _t(x), _t(c)
    blocks = torch.tensor_split(ct, parts)
    s = sum(tfk.fuzzy_normalizer(xt, b, m) for b in blocks)
    whole = tfk.fuzzy_normalizer(xt, ct, m)
    np.testing.assert_allclose(s.numpy(), whole.numpy(), rtol=S_RTOL)
    per = [tfk.fuzzy_accumulate(xt, b, s, m) for b in blocks]
    got = tfk.FuzzyStats(
        weighted_sums=torch.cat([p.weighted_sums for p in per]),
        weights=torch.cat([p.weights for p in per]),
        objective=sum(p.objective for p in per))
    scale = _abs_sums(x, c, whole.double().numpy(), m)
    for want in (tfk.fuzzy_accumulate(xt, ct, whole, m),
                 tfk.fuzzy_stats_fused(xt, ct, m)):
        _assert_stats(got, want, scale)
    # And against the JAX kernels on the same blocks, with the JAX sum.
    s_j = sum(np.asarray(jpk.fuzzy_normalizer(x, b.numpy(), m))
              for b in blocks)
    np.testing.assert_allclose(s.numpy(), s_j.reshape(-1), rtol=S_RTOL)


@pytest.mark.parametrize("m", MS)
def test_b8_takes_an_external_s(m):
    """B8 with an s that came from outside (here: twice its own, as if
    another shard held centroids with the same normaliser) scales every
    membership by 1/2: μ by 2^−m, against the JAX kernel given the same
    s."""
    x, c = _case("even", seed=2)
    s = tfk.fuzzy_normalizer(_t(x), _t(c), m)
    got = tfk.fuzzy_accumulate(_t(x), _t(c), 2 * s, m)
    own = tfk.fuzzy_accumulate(_t(x), _t(c), s, m)
    np.testing.assert_allclose(got.weights.numpy(),
                               own.weights.numpy() * 2.0 ** -m, rtol=RTOL)
    want = jpk.fuzzy_accumulate(x, c, 2 * s.numpy()[:, None], m)
    _assert_stats(got, want, _abs_sums(x, c, 2 * s.double().numpy(), m))


def test_b7_b8_errors_and_counts():
    x, c = _case("even")
    xt, ct = _t(x), _t(c)
    s = tfk.fuzzy_normalizer(xt, ct)
    before = (tfk.fuzzy_normalizer.launches, tfk.fuzzy_accumulate.launches)
    tfk.fuzzy_stats_twopass(xt, ct)
    tfk.fuzzy_accumulate(xt, ct, s)
    # The plain versions run on CPU tensors: no kernel launched, no count.
    assert (tfk.fuzzy_normalizer.launches,
            tfk.fuzzy_accumulate.launches) == before
    for fn, args in ((tfk.fuzzy_normalizer, (xt, ct)),
                     (tfk.fuzzy_accumulate, (xt, ct, s)),
                     (tfk.fuzzy_stats_twopass, (xt, ct))):
        for m in (1.0, 0.5):
            with pytest.raises(ValueError, match="m must be > 1"):
                fn(*args, m)
    with pytest.raises(ValueError, match="d="):
        tfk.fuzzy_normalizer(xt, ct[:, :3])
    with pytest.raises(ValueError, match="2-D"):
        tfk.fuzzy_normalizer(xt[0], ct)
    with pytest.raises(TypeError):
        tfk.fuzzy_normalizer(xt.double(), ct.double())
    with pytest.raises(ValueError, match="one normaliser per row"):
        tfk.fuzzy_accumulate(xt, ct, s[:-1])
    with pytest.raises(ValueError, match="one normaliser per row"):
        tfk.fuzzy_accumulate(xt, ct, s[:, None])
    with pytest.raises(TypeError, match="float32"):
        tfk.fuzzy_accumulate(xt, ct, s.double())


def test_resolve_kernel_fuzzy_sharded_picks_the_two_pass_kernels():
    """'auto' for the K-sharded tower: B7 + B8 ('pallas') on CUDA, the
    plain ops ('xla') on the CPU, as the JAX package's policy picks its
    two-pass kernels on a TPU."""
    from tdc_tpu_torch.ops import lloyd_kernels as tlk

    for dev, want in (("cuda", "pallas"), ("cpu", "xla")):
        assert tlk.resolve_kernel("auto", k=8192, d=768, device=dev,
                                  model="fuzzy_sharded") == want
    assert tlk.resolve_kernel("pallas", k=8, d=4, device="cpu",
                              model="fuzzy_sharded") == "pallas"


# The μ scratch of B8's (and B6's) phase 2 past d = 128 is sized on the
# host, so its plan is checked here: the K-sharded route's shape at all K
# and at K/2, ragged shapes, more rows than the budget holds at one K
# tile, no rows, and a budget cut down so that both K and the rows split
# into several chunks (the card test of that case is in
# tests/test_torch_cuda.py).
PLAN_SHAPES = [(1 << 19, 16384, 768), (1 << 19, 8192, 768), (3001, 130, 130),
               (1 << 23, 300, 769), (0, 70, 769), (1, 1, 129)]
SMALL_BUDGET = 3 * 128 * 128 * 4


@pytest.mark.parametrize("budget", [None, SMALL_BUDGET])
@pytest.mark.parametrize("n,k,d", PLAN_SHAPES)
def test_mu_scratch_plan_stays_in_its_budget(n, k, d, budget, monkeypatch):
    if budget is not None:
        monkeypatch.setattr(tfk, "MU_SCRATCH_BYTES", budget)
    rc, kc, grid = tfk.mu_scratch_plan(n, k, d, 264)
    assert rc % 128 == 0 and kc % 128 == 0 and rc >= 128 and kc >= 128
    assert 4 * rc * kc <= tfk.MU_SCRATCH_BYTES
    assert kc <= -(-k // 128) * 128 and rc <= max(1, -(-n // 128)) * 128
    assert 1 <= grid <= rc // 128
    if n < 4096:
        # The chunk loops of tdc_fuzzy_accumulate_mu cover every (row,
        # centroid) pair exactly once.
        seen = np.zeros((n, k), dtype=np.int32)
        for k0 in range(0, k, kc):
            for r0 in range(0, n, rc):
                seen[r0:r0 + rc, k0:k0 + kc] += 1
        assert (seen == 1).all()


def test_mu_scratch_plan_at_the_route_shape(monkeypatch):
    # One row chunk of all 2^19 rows and 256 centroids (512 MiB), 11 row
    # ranges for 264 CTAs over 4 K tiles x 6 d slices; with the budget
    # cut to three 128 x 128 tiles, 8 row chunks of 384 rows and 2 K
    # chunks of 128 centroids.
    assert tfk.mu_scratch_plan(1 << 19, 16384, 768, 264) == (1 << 19, 256, 11)
    monkeypatch.setattr(tfk, "MU_SCRATCH_BYTES", SMALL_BUDGET)
    assert tfk.mu_scratch_plan(3001, 130, 130, 264) == (384, 128, 3)


# B6 and B9 pass phase 1's (row, component) values to phase 2 through a
# scratch of whole K rows (`row_scratch_plan`), one row chunk at a time:
# the routes' shape (B6: 128-component K tiles, one slice of x; B9: 64,
# x and its squares), ragged K, a slice of x past d = 128, huge K (one
# 128-row block is over the budget and is taken anyway), no rows, one row,
# and the budget cut down to a few row blocks (the card tests of that case
# are in tests/test_torch_cuda.py).
ROW_PLAN_SHAPES = [(1 << 22, 1024, 128, 1), (1 << 22, 1024, 64, 1),
                   ((1 << 16) + 37, 300, 64, 1), (3001, 130, 64, 2),
                   (0, 70, 128, 1), (1, 1, 128, 1),
                   (1 << 20, 1 << 21, 128, 6)]


@pytest.mark.parametrize("budget", [None, SMALL_BUDGET])
@pytest.mark.parametrize("n,k,comps,slices", ROW_PLAN_SHAPES)
def test_row_scratch_plan_stays_in_its_budget(n, k, comps, slices, budget,
                                              monkeypatch):
    if budget is not None:
        monkeypatch.setattr(tfk, "MU_SCRATCH_BYTES", budget)
    rc, kp, grid = tfk.row_scratch_plan(n, k, comps, slices, 132)
    assert kp % comps == 0 and kp % 64 == 0 and k <= kp < k + comps
    assert rc % 128 == 0 and 128 <= rc <= max(1, -(-n // 128)) * 128
    if 4 * 128 * kp <= tfk.MU_SCRATCH_BYTES:
        assert 4 * rc * kp <= tfk.MU_SCRATCH_BYTES
    else:
        assert rc == 128
    assert 1 <= grid <= rc // 128
    tiles = kp // comps * slices
    assert grid * tiles <= max(132, tiles)
    if n < 4096:
        # The chunk loops of tdc_fuzzy_stats and tdc_gmm_stats cover every
        # row exactly once.
        seen = np.zeros(n, dtype=np.int32)
        for r0 in range(0, n, rc):
            seen[r0:r0 + rc] += 1
        assert (seen == 1).all()


def test_row_scratch_plan_at_the_route_shape(monkeypatch):
    # N=2^22, K=1024 on 132 SMs: 32 row chunks of 131,072 rows (512 MiB),
    # 16 row ranges for B6's 8 K tiles and 8 for B9's 16; the ragged shape
    # in one chunk; with the budget cut, 12 chunks of 256 rows.
    assert tfk.row_scratch_plan(1 << 22, 1024, 128, 1, 132) == (131072,
                                                                 1024, 16)
    assert tfk.row_scratch_plan(1 << 22, 1024, 64, 1, 132) == (131072,
                                                                1024, 8)
    assert tfk.row_scratch_plan((1 << 16) + 37, 300, 64, 1, 132) == (
        65664, 320, 26)
    monkeypatch.setattr(tfk, "MU_SCRATCH_BYTES", SMALL_BUDGET)
    assert tfk.row_scratch_plan(3001, 130, 64, 2, 132) == (256, 192, 2)


@pytest.mark.parametrize("n,k,comps,slices", ROW_PLAN_SHAPES)
def test_phase1_k_splits_fill_the_card(n, k, comps, slices):
    # Phase 1 of B6 and B9 splits each row block's 64-wide K tiles among
    # `splits` CTAs: at least one tile a split, and a chunk's launch
    # reaches the target CTAs wherever the K tiles allow.
    rc, _, _ = tfk.row_scratch_plan(n, k, comps, slices, 132)
    splits = tfk.phase1_k_splits(rc, k, 264)
    tiles = -(-k // 64)
    assert 1 <= splits <= tiles
    assert (rc // 128) * splits >= min(264, (rc // 128) * tiles)
    # Each split's range of K tiles, as the phase-1 kernels take it, is
    # contiguous, non-empty, and together they cover every tile once.
    bounds = [tiles * j // splits for j in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert all(a < b for a, b in zip(bounds, bounds[1:]))


def test_phase1_k_splits_at_the_routes_and_large_k():
    # The routes' shape fills the card with 1,024 row blocks a chunk: one
    # split. At K=16,384 a chunk holds 8,192 rows (64 blocks): 5 splits,
    # 320 CTAs a launch; the ragged shape (513 blocks in one chunk): 1.
    assert tfk.phase1_k_splits(131072, 1024, 264) == 1
    rc, _, _ = tfk.row_scratch_plan(1 << 19, 16384, 128, 6, 132)
    assert rc == 8192 and tfk.phase1_k_splits(rc, 16384, 264) == 5
    assert tfk.phase1_k_splits(65664, 300, 264) == 1
    # Few rows: every K tile its own split, but no more.
    assert tfk.phase1_k_splits(128, 130, 264) == 3
