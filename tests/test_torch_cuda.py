"""The port's CUDA kernels against their plain versions on the card, at
small shapes (the full-size check is chip_smoke.py). Marked `cuda`: they
skip without a card. Run them on one with
`python -m pytest tests/test_torch_cuda.py -q`.

Tolerances: labels and counts equal; sums and distances within rtol 1e-5
and atol 1e-4 (float32, different summation order); two runs bitwise
equal. With duplicated centroids every tie goes to the smallest index.
B6 (fuzzy stats): weighted sums within 1e-5 of Σμ|x| per cluster, weights
and objective within rtol 1e-5, two runs bitwise equal, also across
several row chunks of its scratch. B7 and B8 (the
two-pass fuzzy kernels of the K-sharded tower) on f32 and bf16 rows: s
within rtol 1e-5 of the plain version's, B8 as B6 and bitwise equal with
and without B7's ‖x‖²; s summed over two K-shards and B8 per shard give
B6's stats on all K within the same tolerances. B4 (weighted
Lloyd stats): sums within rtol 1e-5 and atol 1e-4, the mass and the SSE
within rtol 1e-5, two runs bitwise equal; copies of a centroid take no
mass. B9 (the diag-GMM E-step): Σr·x within 1e-5 of Σr|x| per component,
Σr·x², nk and ll_sum within rtol 1e-5, two runs bitwise equal, also with
the scratch budget of B6 and B9 cut to a few row blocks; a diag
kernel fit against the plain fit: equal n_iter and converged, means
within 1e-4, the mean log-likelihood within rtol 1e-5. B5 (bf16 cross
operands on the tensor cores) on f32 and bf16 rows: labels and counts
equal to the plain version's (the blobs keep every row far from a tie in
B5's own metric), sums within rtol 1e-5 and atol 1e-4, SSE within rtol
1e-5, two runs bitwise equal; centroids that differ in f32 but round to
the same bf16 values tie on bf16 rows and the smaller index wins; a bf16
kernel fit against the same fit on the CPU (plain version): equal n_iter
and converged, centroids within 1e-4. The edges of B5's tensor-core
design (K = 1, K = 37, K·d at FUSED_MAX_KD, d = 8, 200 and 300, N = 1, a
misaligned base) on f32 and bf16 rows: labels equal but at near-ties in
B5's own metric, counts equal where they agree, sums within 1e-5 of Σ|x|
against f64 sums by the kernel's own labels, SSE within rtol 1e-5,
bitwise repeatable. B10 and B11 (the feature-major
Lloyd and fuzzy stats) on f32 and bf16 columns, in the private (small
K·(d+1)) and tile forms: B10 as B1 (labels and counts equal, sums within
rtol 1e-5 and atol 1e-4), B11 as B6, both bitwise repeatable (the
private form at d ≤ 8 in one and two register groups of centroids, the
tile form past it); copies of a
centroid take no columns in B10 and the same mass as the original in
B11; the edges of B11's private form (its μᵀ·X on the tensor cores: d =
1, 7 and 8, K = 1, 15, 16 and 48, K·(d+1) = 96, and 97 and 98 on the
tile form) at ragged N, m = 2 and 1.7, f32 and bf16 columns, as B6, with
copied centroids taking the original's mass bitwise; layout="features"
fits on the card against the same fits on the
CPU: equal n_iter and converged, centroids within 1e-4. B12 (B3 with the
row gather fused in) on f32 and bf16 rows: bitwise equal to B3 on the
gathered rows (widened to f32), bitwise repeatable, within rtol 1e-5 and
atol 1e-4 of its plain version; the fused and unfused sorted stats are
bitwise equal. The edges of B3's and B12's design (scalar widths,
misaligned rows, a run over hundreds of chunks, empty segments, rows
outside the segments, one segment of every row): B3 within 1e-5 of Σ|x|
per segment of f64 sums on the card (the plain version's f32
`index_add_` adds in the varying order of its atomics), empty segments
exactly zero, B12 bitwise B3 on the gathered rows. The edges of B1's
and B4's tensor-core design (several 128-column chunks, the scalar path,
a misaligned base, K at the route limit, N below one block and not a
multiple of it) and a near-tie input: labels equal to the plain
version's but at near-ties (within 1e-5 of ‖x‖² + max ‖c‖²), counts
equal and sums within 1e-5 of Σ|x| (B4: Σw|x|) where they all agree,
else against f64 sums by the kernel's own labels, the mass and SSE
within rtol 1e-5, two runs bitwise equal. B8's μ-scratch design (d = 130 and 769, and
d = 7 on the one-slice kernel; ragged N and K, s from two K-shards, a
scratch budget cut down to several chunks): as B6, bitwise repeatable.
The edges of B2's and B7's tensor-core design (N ragged and below one
block; K = 1, K < 256, a partial last 256-centroid tile; d = 1, 19, 64,
128, 130, 768, 769; a misaligned base): B2's labels equal to the plain
version's and its minima (both forms) within rtol 1e-5 and atol 1e-4,
B7's s within rtol 1e-5 at m = 2 and 1.7 with B8 bitwise equal with and
without B7's ‖x‖², both bitwise repeatable; B2 on near-tie inputs (d =
768 and 19): labels equal but at near-ties; copies of a centroid in the
same and the next K tiles go to the smallest index; rows equal to
centroids: B7 then B8 give memberships that sum to at most 1 a row. The
edges of B10's streaming form (N = 1, 1000, one column past a tile with
12 and 8 warps, misaligned rows and base, a ring that wraps, d = 1..8 at
K·(d+1) = 144, K = 1..3, the tile form just past it) on f32 and bf16
columns: labels equal to the plain version's but at near-ties (within
1e-5 of ‖x‖² + max ‖c‖² in f64), counts equal where they agree, sums
within 1e-5 of Σ|x| against f64 sums by the kernel's own labels, SSE
within rtol 1e-5, two runs bitwise equal; its stream-only path reads
every column once (Σ‖x‖² within rtol 1e-5); copies of a centroid across
its groups of 4 take no columns; columns on centroids and past the f32
range take the exact path and the smallest index. The streamed fits
(K-Means on B1, Fuzzy C-Means on B6, diag GMM on B9, 7 batches with a
ragged last one) against the same streamed fits on the CPU: equal n_iter
and converged, centroids within 1e-4, the cost within rtol 1e-5, one
launch per batch of each pass. A real out-of-memory error in
`oom_adaptive`'s first attempt: the retry, at twice the batches, finds
memory_allocated() at its level before the fit. A features-layout fit on
B10's tile form (K=17, d=8: K·(d+1) = 153) against the CPU fit: equal
n_iter and converged, centroids within 1e-4. Residency: the streamed
K-Means (B1) and fuzzy (B6) fits under 'hbm' and 'spill' on the card are
bitwise the 'stream' fit, the ring's host buffers are pinned and its
copies run on streams other than the consumer's, and the 'hbm' fit
launches its kernel once per cached batch of every pass."""

import pytest
import torch

from tdc_tpu_torch.models import fuzzy as tfz
from tdc_tpu_torch.models import gmm as tgmm
from tdc_tpu_torch.models import kmeans as tkm
from tdc_tpu_torch.ops import fuzzy_kernels as fk
from tdc_tpu_torch.ops import gmm_kernels as gk
from tdc_tpu_torch.ops import lloyd_kernels as lk
from tdc_tpu_torch.ops import sorted_stats as ss
from tdc_tpu_torch.ops import tall as tt
from tdc_tpu_torch.ops.assign import fuzzy_memberships

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _data(gen, n, k, d):
    centers = torch.rand((k, d), generator=gen, device="cuda") * 6 - 3
    labels = torch.arange(n, device="cuda") % k
    x = torch.randn((n, d), generator=gen, device="cuda") + centers[labels]
    return x, centers


@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128)])
def test_b1_b2_b3_match_plain(gen, n, k, d):
    x, c = _data(gen, n, k, d)
    lab, mind = lk.distance_argmin(x, c, return_dist=True)
    plab, pmind = lk.distance_argmin_plain(x, c, return_dist=True)
    assert torch.equal(lab, plab)
    torch.testing.assert_close(mind, pmind, rtol=1e-5, atol=1e-4)
    st = lk.lloyd_stats_fused(x, c)
    again = lk.lloyd_stats_fused(x, c)
    want = lk.lloyd_stats_fused_plain(x, c)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    assert torch.equal(st.counts, want.counts)
    torch.testing.assert_close(st.sums, want.sums, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st.sse, want.sse, rtol=1e-5, atol=1e-4)
    sums, counts = ss.sorted_cluster_stats(x, lab, k, pallas=True)
    assert torch.equal(counts, want.counts)
    torch.testing.assert_close(sums, want.sums, rtol=1e-5, atol=1e-4)


def _segment_sums_f64(xs, starts):
    """B3's sums in f64 on the card, the reference of the B3 and B12
    tests: the plain version's f32 `index_add_` adds in the order its
    atomics land, which changes from run to run by more than B3's own
    error over a long run; in f64 that order moves nothing at f32
    tolerances."""
    lengths = (starts[1:] - starts[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(starts.numel() - 1, device=xs.device), lengths)
    lo = int(starts[0])
    out = torch.zeros((starts.numel() - 1, xs.shape[1]), dtype=torch.float64,
                      device=xs.device)
    return out.index_add_(0, seg, xs[lo:lo + seg.numel()].double())


def test_b3_long_runs_and_empty_segments(gen):
    # Rows before the first segment and after the last, empty segments, a
    # run across ~125 chunks of rows and runs at chunk edges.
    xs = torch.randn((5000, 40), generator=gen, device="cuda")
    starts = torch.tensor([3, 3, 4000, 4000, 4031, 4032, 4064, 4900],
                          dtype=torch.int32, device="cuda")
    got = ss.segment_sums(xs, starts)
    assert torch.equal(got, ss.segment_sums(xs, starts))
    torch.testing.assert_close(got.double(), _segment_sums_f64(xs, starts),
                               rtol=1e-5, atol=1e-4)
    assert not got[0].any() and not got[2].any()


# Edge cases of B3's and B12's design: widths that are not a multiple of
# 4 (scalar loads; d = 769 is the weighted sorted route's), rows whose
# base is not 16-byte aligned, a run over hundreds of 32-row chunks (its
# heads summed in groups), empty segments at both ends, starts[0] > 0,
# rows past the last segment, and one segment holding every row (alone,
# and followed by empty segments at N). Each: (N, d, starts or None for
# random labels over 50 segments).
SEGMENT_CASES = {
    "d769": (5000, 769, None),
    "d131": (5000, 131, None),
    "d3": (4000, 3, None),
    "misaligned": (5000, 64, None),
    "long_run": (30000, 64, [0, 10, 20010, 20011, 30000]),
    "empty_ends": (3000, 40, [0, 0, 0, 100, 2000, 3000, 3000, 3000]),
    "offset_start": (2000, 48, [37, 500, 1500, 1600]),
    "one_segment": ((1 << 17) + 5, 32, [0, (1 << 17) + 5]),
    "one_segment_then_empty": (1 << 16, 16, [0] + [1 << 16] * 100),
}


def _rows(t: torch.Tensor, misaligned: bool) -> torch.Tensor:
    """t itself, or a contiguous copy whose base is one element past a
    16-byte boundary."""
    if not misaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_b3_b12_design_edges(gen, case):
    n, d, starts = SEGMENT_CASES[case]
    x = torch.randn((n, d), generator=gen, device="cuda")
    if starts is None:
        lab = torch.randint(0, 50, (n,), generator=gen, device="cuda")
        keys, order = torch.sort(lab.to(torch.int32), stable=True)
        starts = torch.searchsorted(
            keys, torch.arange(51, dtype=torch.int32, device="cuda"))
    else:
        order = torch.randperm(n, generator=gen, device="cuda")
    starts = torch.as_tensor(starts, device="cuda").to(torch.int32)
    order = order.to(torch.int32)
    mis = case == "misaligned"
    xs = _rows(x.index_select(0, order).contiguous(), mis)
    got = ss.segment_sums(xs, starts)
    assert torch.equal(got, ss.segment_sums(xs, starts))
    # Within 1e-5 of Σ|x| per segment: a sum of m terms in another order
    # differs by up to m·2^-24·Σ|x| (runs here reach 20,000 rows).
    err = (got.double() - _segment_sums_f64(xs, starts)).abs()
    assert (err <= 1e-5 * _segment_sums_f64(xs.abs(), starts) + 1e-6).all()
    empty = (starts[1:] == starts[:-1]).nonzero().flatten()
    assert not got[empty].any()
    # B12 on the unsorted rows: bitwise B3 on the gathered rows, f32 and
    # bf16 (widened), whatever path each takes.
    for rows in (x, x.to(torch.bfloat16)):
        rows = _rows(rows, mis)
        g12 = ss.gathered_segment_sums(rows, order, starts)
        assert torch.equal(g12, ss.gathered_segment_sums(rows, order, starts))
        want = ss.segment_sums(
            rows.index_select(0, order).float().contiguous(), starts)
        assert torch.equal(g12, want)


def _fuzzy_abs_sums(x, c, s, m, eps=1e-9):
    """Σμ|x| per (cluster, feature) with μ = ((d² + eps)^p / s)^m for the
    given s, in f64: the scale of the Σμx check."""
    xd, cd = x.double(), c.double()
    d2 = ((xd * xd).sum(1, keepdim=True) + (cd * cd).sum(1)
          - 2 * xd @ cd.T).clamp_min(0)
    mu = ((d2 + eps) ** (-1.0 / (m - 1.0)) / s.double()[:, None]) ** m
    return mu.T @ xd.abs()


@pytest.mark.parametrize("small_scratch", [False, True])
@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("n,k,d", [(3001, 130, 7), (3001, 130, 130),
                                   (2000, 70, 769)])
def test_b8_one_distance_product_design(gen, n, k, d, m, small_scratch,
                                        monkeypatch):
    # B8 past d = 128 takes the μ scratch; d = 7 stays on the one-slice
    # kernel. K is not a multiple of the 64-centroid tile and N is ragged;
    # s comes from two K-shards. With the scratch budget cut to three
    # tiles, the 130 and 769 cases cross several K chunks and row chunks.
    if small_scratch:
        monkeypatch.setattr(fk, "MU_SCRATCH_BYTES", 3 * 128 * 128 * 4)
    x, c = _data(gen, n, k, d)
    halves = (c[:k // 2].contiguous(), c[k // 2:].contiguous())
    s = fk.fuzzy_normalizer(x, halves[0], m) + fk.fuzzy_normalizer(
        x, halves[1], m)
    for h in halves:
        st = fk.fuzzy_accumulate(x, h, s, m)
        assert all(torch.equal(a, b)
                   for a, b in zip(st, fk.fuzzy_accumulate(x, h, s, m)))
        want = fk.fuzzy_accumulate_plain(x, h, s, m)
        scale = _fuzzy_abs_sums(x, h, s, m).float()
        assert ((st.weighted_sums - want.weighted_sums).abs()
                <= 1e-5 * scale + 1e-6).all()
        torch.testing.assert_close(st.weights, want.weights, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(st.objective, want.objective, rtol=1e-5,
                                   atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128),
                                   (0, 5, 40)])
def test_b12_is_b3_on_the_gathered_rows(gen, n, k, d, dtype):
    # Labels past k (the K-sharded sentinel) sort last and are skipped.
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    lab = torch.randint(0, k + 3, (n,), generator=gen, device="cuda")
    keys, order = torch.sort(lab.to(torch.int32), stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(k + 1, dtype=torch.int32, device="cuda")
    ).to(torch.int32)
    order = order.to(torch.int32)
    before = ss.gathered_segment_sums.launches
    got = ss.gathered_segment_sums(x, order, starts)
    assert ss.gathered_segment_sums.launches == before + 1
    assert torch.equal(got, ss.gathered_segment_sums(x, order, starts))
    want = ss.segment_sums(x.index_select(0, order).float().contiguous(),
                           starts)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.double(),
        _segment_sums_f64(x.index_select(0, order).float(), starts),
        rtol=1e-5, atol=1e-4)
    fused = ss.sorted_cluster_stats(x, lab, k, pallas=True, fuse_gather=True)
    unfused = ss.sorted_cluster_stats(x, lab, k, pallas=True)
    assert all(torch.equal(a, b) for a, b in zip(fused, unfused))


@pytest.mark.parametrize("d", [19, 128])
def test_ties_go_to_the_smallest_index(gen, d):
    # Copies of centroid 3: in the same 256-centroid K tile of B1 and B2
    # on another lane (5) and on other threads (67, 200), and in the next,
    # partial tile (299).
    k, copies = 300, [5, 67, 200, 299]
    x, c = _data(gen, 4000, k, d)
    c[copies] = c[3].clone()
    lab = lk.distance_argmin(x, c)[0]
    assert torch.equal(lab, lk.distance_argmin_plain(x, c)[0])
    assert not torch.isin(lab, torch.tensor(copies, device="cuda")).any()
    want = torch.bincount(lab.long(), minlength=k).to(torch.float32)
    assert torch.equal(lk.lloyd_stats_fused(x, c).counts, want)
    sums, counts = ss.sorted_cluster_stats(x, lab, k, pallas=True)
    assert torch.equal(counts, want) and not sums[copies].any()


# A scratch budget of three 128-row blocks of one 128-wide K tile: B6
# and B9 then run several row chunks and add their partials across chunk
# edges.
SMALL_SCRATCH = 3 * 128 * 128 * 4


@pytest.mark.parametrize("small_scratch", [False, True])
@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128),
                                   (3001, 130, 130), (2000, 70, 769)])
def test_b6_matches_plain(gen, n, k, d, m, small_scratch, monkeypatch):
    # d = 130 and 769 take several 128-column slices of phase 2 (the last
    # one ragged), d = 769 also the scalar loads.
    if small_scratch:
        monkeypatch.setattr(fk, "MU_SCRATCH_BYTES", SMALL_SCRATCH)
    x, c = _data(gen, n, k, d)
    st = fk.fuzzy_stats_fused(x, c, m)
    again = fk.fuzzy_stats_fused(x, c, m)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    want = fk.fuzzy_stats_fused_plain(x, c, m)
    scale = (fuzzy_memberships(x, c, m) ** m).T @ x.abs()  # Σμ|x|
    assert ((st.weighted_sums - want.weighted_sums).abs()
            <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(st.weights, want.weights, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(st.objective, want.objective, rtol=1e-5,
                               atol=0.0)


def _assert_fuzzy(st, want, x, c, m):
    """Σμx within 1e-5 of Σμ|x|, Σμ and J_m within rtol 1e-5."""
    scale = (fuzzy_memberships(x, c, m) ** m).T @ x.abs()  # Σμ|x|
    assert ((st.weighted_sums - want.weighted_sums).abs()
            <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(st.weights, want.weights, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(st.objective, want.objective, rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("n,k,d", [(1000, 38, 19), (5000, 130, 128)])
def test_b7_b8_match_plain_and_b6(gen, n, k, d, m, dtype):
    x, c = _data(gen, n, k, d)
    x = x.to(dtype)
    xw, cw = lk.widened(x, c)  # what both kernels compute on
    s, x2 = fk.fuzzy_normalizer(x, c, m, return_x2=True)
    assert torch.equal(s, fk.fuzzy_normalizer(x, c, m))
    torch.testing.assert_close(s, fk.fuzzy_normalizer_plain(xw, cw, m),
                               rtol=1e-5, atol=0.0)
    st = fk.fuzzy_accumulate(x, c, s, m, x2=x2)
    # Without x2, B8 computes ‖x‖² itself, to the same bits as B7.
    again = fk.fuzzy_accumulate(x, c, s, m)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    _assert_fuzzy(st, fk.fuzzy_accumulate_plain(xw, cw, s, m), xw, cw, m)
    # The tower's identity on one process: s summed over two K-shards,
    # B8 per shard with that s, equals B6 on all K; B6 counts only B6.
    counts = (fk.fuzzy_normalizer.launches, fk.fuzzy_accumulate.launches)
    whole = fk.fuzzy_stats_fused(x, c, m)
    assert (fk.fuzzy_normalizer.launches,
            fk.fuzzy_accumulate.launches) == counts
    halves = (c[:k // 2].contiguous(), c[k // 2:].contiguous())
    s2 = fk.fuzzy_normalizer(x, halves[0], m) + fk.fuzzy_normalizer(
        x, halves[1], m)
    per = [fk.fuzzy_accumulate(x, h, s2, m) for h in halves]
    got = type(whole)(torch.cat([p.weighted_sums for p in per]),
                      torch.cat([p.weights for p in per]),
                      per[0].objective + per[1].objective)
    _assert_fuzzy(got, whole, xw, cw, m)
    assert fk.fuzzy_normalizer.launches == counts[0] + 2
    assert fk.fuzzy_accumulate.launches == counts[1] + 2


def _weights(gen, n):
    w = torch.rand(n, generator=gen, device="cuda") * 3
    w[::17] = 0.0  # zero-weight rows add nothing
    return w


@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128)])
def test_b4_matches_plain(gen, n, k, d):
    x, c = _data(gen, n, k, d)
    w = _weights(gen, n)
    st = lk.lloyd_stats_fused_weighted(x, c, w)
    again = lk.lloyd_stats_fused_weighted(x, c, w)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    want = lk.lloyd_stats_fused_weighted_plain(x, c, w)
    for got in (st, ss.lloyd_stats_sorted_weighted(x, c, w)):
        torch.testing.assert_close(got.sums, want.sums, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got.counts, want.counts, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got.sse, want.sse, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("d", [19, 128])
def test_b4_ties_take_no_mass(gen, d):
    k, copies = 300, [5, 67, 200, 299]
    x, c = _data(gen, 4000, k, d)
    c[copies] = c[3].clone()
    w = _weights(gen, 4000)
    lab = lk.distance_argmin_plain(x, c)[0].long()
    mass = torch.zeros(k, device="cuda").index_add_(0, lab, w)
    for got in (lk.lloyd_stats_fused_weighted(x, c, w),
                ss.lloyd_stats_sorted_weighted(x, c, w)):
        assert not got.counts[copies].any() and not got.sums[copies].any()
        torch.testing.assert_close(got.counts, mass, rtol=1e-5, atol=1e-5)


# Edges of B1's and B4's tensor-core design (N, K, d): several 128-column
# chunks of x (d = 130, 769: restaged per 256-centroid K tile); d % 4 != 0
# and a base one float past a 16-byte boundary (the scalar loads and
# accumulate); K at the route limit (16 K tiles); N below one 128-row
# block and N not a multiple of it.
FUSED_CASES = {
    "d130": (3001, 130, 130),
    "d769": (2000, 70, 769),
    "scalar_d19": (3001, 37, 19),
    "misaligned": (3001, 130, 128),
    "route_limit_k": ((1 << 14) + 3, 4096, 128),
    "below_one_block": (100, 37, 64),
    "ragged_blocks": (128 * 5 + 17, 300, 64),
}


def _near_tie_data(gen, n, k, d, ways=2):
    """Points off the point equidistant from centroids i % k .. (i + ways
    - 1) % k in their affine span (at ways = 2 the midpoint) by a
    Gaussian offset whose scale, drawn per row, is log-uniform over
    1e-6..10^-2.5 a coordinate: the true gaps between the candidates'
    distances run from far inside the near-tie limit (1e-5 of ‖x‖² +
    max ‖c‖²) to some ten times past it, where a product coarser than f32
    (one TF32 pass) flips labels and the label check fails it. At ways =
    3 one TF32 pass also drops the nearest of three candidates out of a
    kernel's two best."""
    c = torch.rand((k, d), generator=gen, device="cuda") * 6 - 3
    group = (torch.arange(k, device="cuda")[:, None]
             + torch.arange(ways, device="cuda")) % k
    p = c.double()[group]
    u = p[:, 1:] - p[:, :1]  # (U Uᵀ) α = ‖u_i‖² / 2
    gram = u @ u.transpose(1, 2)
    alpha = torch.linalg.solve(gram, 0.5 * gram.diagonal(dim1=1, dim2=2))
    center = (p[:, 0] + (alpha[:, None] @ u)[:, 0]).float()
    x = center[torch.arange(n, device="cuda") % k]
    s = 10.0 ** (-6.0 + 3.5 * torch.rand((n, 1), generator=gen,
                                         device="cuda"))
    return x + s * torch.randn((n, d), generator=gen, device="cuda"), c


def _rows_past_tie_limit(x, c, ways=2):
    """Rows of _near_tie_data's input whose group's nearest and farthest
    candidates lie past the near-tie limit from each other and within ten
    times it."""
    n, k = x.shape[0], c.shape[0]
    group = (torch.arange(n, device="cuda")[:, None]
             + torch.arange(ways, device="cuda")) % k
    xd, cd = x.double(), c.double()
    dist = torch.stack([((xd - cd[group[:, i]]) ** 2).sum(1)
                        for i in range(ways)], 1)
    gap = dist.max(1).values - dist.min(1).values
    lim = 1e-5 * ((xd * xd).sum(1) + (cd * cd).sum(1).max())
    return int(((gap > lim) & (gap <= 10 * lim)).sum())


def _check_fused(x, c, w=None):
    """B1 (w None) or B4 against its plain version: two runs bitwise
    equal; labels equal to the plain version's but at near-ties (within
    1e-5 of ‖x‖² + max ‖c‖², in f64); counts equal (B1) and the sums
    within 1e-5 of Σ|x| (B4: Σw|x|) per cluster where the labels agree,
    else against f64 sums by the kernel's own labels; the mass and the
    SSE within rtol 1e-5. Returns the number of near-tie labels."""
    k = c.shape[0]
    if w is None:
        got, lab = lk.lloyd_stats_fused(x, c, return_labels=True)
        again, lab2 = lk.lloyd_stats_fused(x, c, return_labels=True)
        want, plab = lk.lloyd_stats_fused_plain(x, c, return_labels=True)
        wt = torch.ones(x.shape[0], device="cuda")
    else:
        got, lab = lk.lloyd_stats_fused_weighted(x, c, w, return_labels=True)
        again, lab2 = lk.lloyd_stats_fused_weighted(x, c, w,
                                                    return_labels=True)
        want, plab = lk.lloyd_stats_fused_weighted_plain(
            x, c, w, return_labels=True)
        wt = w
    assert all(torch.equal(a, b) for a, b in zip((*got, lab),
                                                 (*again, lab2)))
    diff = (lab != plab).nonzero().flatten()
    if diff.numel():
        xd = x[diff].double()
        dg = ((xd - c[lab[diff].long()].double()) ** 2).sum(1)
        dw = ((xd - c[plab[diff].long()].double()) ** 2).sum(1)
        scale = (xd * xd).sum(1) + (c.double() ** 2).sum(1).max()
        assert ((dg - dw).abs() <= 1e-5 * scale).all()
    ref_lab = plab if not diff.numel() else lab
    abs_sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device="cuda").index_add_(
        0, ref_lab.long(), wt[:, None].double() * x.abs().double())
    if diff.numel():
        ref = torch.zeros_like(abs_sums).index_add_(
            0, lab.long(), wt[:, None].double() * x.double())
    else:
        ref = want.sums.double()
        if w is None:
            assert torch.equal(got.counts, want.counts)
        else:
            torch.testing.assert_close(got.counts, want.counts, rtol=1e-5,
                                       atol=1e-5)
    assert ((got.sums.double() - ref).abs() <= 1e-5 * abs_sums + 1e-6).all()
    torch.testing.assert_close(got.sse, want.sse, rtol=1e-5, atol=0.0)
    return int(diff.numel())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_b1_b4_tensor_core_design_edges(gen, case, weighted):
    n, k, d = FUSED_CASES[case]
    if weighted:  # B4's limit is K·(d+1) <= FUSED_MAX_KD
        k = min(k, lk.FUSED_MAX_KD // (d + 1))
    x, c = _data(gen, n, k, d)
    x = _rows(x.contiguous(), case == "misaligned")
    w = _weights(gen, n) if weighted else None
    before = (lk.lloyd_stats_fused.launches,
              lk.lloyd_stats_fused_weighted.launches)
    _check_fused(x, c, w)
    assert (lk.lloyd_stats_fused.launches,
            lk.lloyd_stats_fused_weighted.launches) == (
        before[0] + 2 * (not weighted), before[1] + 2 * weighted)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,k,d", [(1 << 14, 1024, 128), (5000, 300, 19)])
def test_b1_b4_near_ties(gen, n, k, d, weighted):
    # Labels may differ from the plain version's only at near-ties; a
    # tenth of the rows or more lie past the limit, where a product
    # coarser than f32 would flip some.
    x, c = _near_tie_data(gen, n, k, d)
    assert _rows_past_tie_limit(x, c) >= n // 10
    _check_fused(x, c, _weights(gen, n) if weighted else None)


# Edges of B2's and B7's tensor-core design (N, K, d): N not a multiple
# of the 128-row block and below one block; K with a partial last
# 256-centroid tile, K < 256 and K = 1; d = 1 and 19 (the scalar loads,
# a partial k-step), 128, 130 (a partial column block), 768 (the route's)
# and 769; a base one float past a 16-byte boundary.
DISTANCE_CASES = {
    "d1_k1": (129, 1, 1),
    "d19_k37": (1000, 37, 19),
    "d128_k300": (3001, 300, 128),
    "d130_k257": (777, 257, 130),
    "d768_k1": (300, 1, 768),
    "d768_k37": (1000, 37, 768),
    "d768_k600": (2000, 600, 768),
    "d769_k70": (2000, 70, 769),
    "below_one_block": (100, 37, 64),
    "misaligned": (3001, 130, 128),
}


@pytest.mark.parametrize("return_dist", [True, False])
@pytest.mark.parametrize("case", list(DISTANCE_CASES))
def test_b2_tensor_core_design_edges(gen, case, return_dist):
    # Labels equal to the plain version's (the blobs keep every row far
    # from a tie), minima within rtol 1e-5 and atol 1e-4 in both forms,
    # two runs bitwise equal, one launch a call.
    n, k, d = DISTANCE_CASES[case]
    x, c = _data(gen, n, k, d)
    x = _rows(x.contiguous(), case == "misaligned")
    before = lk.distance_argmin.launches
    lab, mind = lk.distance_argmin(x, c, return_dist=return_dist)
    again = lk.distance_argmin(x, c, return_dist=return_dist)
    assert lk.distance_argmin.launches == before + 2
    assert torch.equal(lab, again[0]) and torch.equal(mind, again[1])
    plab, pmind = lk.distance_argmin_plain(x, c, return_dist=return_dist)
    assert torch.equal(lab, plab)
    torch.testing.assert_close(mind, pmind, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ways", [2, 3])
@pytest.mark.parametrize("n,k,d", [(1 << 14, 1024, 768), (5000, 300, 19)])
def test_b2_near_ties(gen, n, k, d, ways):
    # Labels may differ from the plain version's only at near-ties; a
    # tenth of the rows or more lie past the limit, where a product
    # coarser than f32 would flip some. With three candidates a row, one
    # TF32 pass also drops the nearest out of the kernel's two best, which
    # its f32 decision between those two cannot repair. The minima stay
    # within rtol 1e-5 and atol 1e-4 either way: the candidates' distances
    # nearly tie.
    x, c = _near_tie_data(gen, n, k, d, ways)
    assert _rows_past_tie_limit(x, c, ways) >= n // 10
    lab, mind = lk.distance_argmin(x, c, return_dist=True)
    plab, pmind = lk.distance_argmin_plain(x, c, return_dist=True)
    diff = (lab != plab).nonzero().flatten()
    if diff.numel():
        xd = x[diff].double()
        dg = ((xd - c[lab[diff].long()].double()) ** 2).sum(1)
        dw = ((xd - c[plab[diff].long()].double()) ** 2).sum(1)
        scale = (xd * xd).sum(1) + (c.double() ** 2).sum(1).max()
        assert ((dg - dw).abs() <= 1e-5 * scale).all()
    torch.testing.assert_close(mind, pmind, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("case", list(DISTANCE_CASES))
def test_b7_tensor_core_design_edges(gen, case, m):
    # s within rtol 1e-5 of the plain version's (at K = 1 and 37, d = 768
    # the nearest centroid carries much of s: the champion's f32 rescore
    # holds it), two runs bitwise equal, ‖x‖² bitwise as B8 computes it.
    n, k, d = DISTANCE_CASES[case]
    x, c = _data(gen, n, k, d)
    x = _rows(x.contiguous(), case == "misaligned")
    before = fk.fuzzy_normalizer.launches
    s, x2 = fk.fuzzy_normalizer(x, c, m, return_x2=True)
    assert torch.equal(s, fk.fuzzy_normalizer(x, c, m))
    assert fk.fuzzy_normalizer.launches == before + 2
    torch.testing.assert_close(s, fk.fuzzy_normalizer_plain(x, c, m),
                               rtol=1e-5, atol=0.0)
    st = fk.fuzzy_accumulate(x, c, s, m, x2=x2)
    again = fk.fuzzy_accumulate(x, c, s, m)  # ‖x‖² computed by B8
    assert all(torch.equal(a, b) for a, b in zip(st, again))


@pytest.mark.parametrize("m", [2.0, 1.7])
def test_b7_b8_rows_on_centroids(gen, m):
    # Rows equal to centroids: their nearest d² is all cancellation, so
    # B7's s must hold the inv that B8 computes for that pair, or the
    # row's μ = (inv / s)^m has no bound. Each row's memberships sum to
    # at most 1: Σμ over all K stays within N (rtol 1e-5).
    k, d = 300, 768
    c = torch.rand((k, d), generator=gen, device="cuda") * 6 - 3
    x = torch.cat([c[:64], c[100:164]]).contiguous()
    s = fk.fuzzy_normalizer(x, c, m)
    st = fk.fuzzy_accumulate(x, c, s, m)
    assert torch.isfinite(st.weights).all()
    assert float(st.weights.sum()) <= x.shape[0] * (1 + 1e-5)


@pytest.mark.parametrize("d", [19, 768])
def test_ties_across_the_k_tile_boundary(gen, d):
    # Copies of centroid 3 in its own 256-centroid K tile (5, 67, 200,
    # 255) and in the next ones (256, 300, 511, 512, 599): a later tile
    # wins only on strict <, so every tie goes to the smallest index; B7
    # counts each copy in s, as the plain version does.
    k, copies = 600, [5, 67, 200, 255, 256, 300, 511, 512, 599]
    x, c = _data(gen, 3000, k, d)
    c[copies] = c[3].clone()
    lab = lk.distance_argmin(x, c)[0]
    assert torch.equal(lab, lk.distance_argmin_plain(x, c)[0])
    assert not torch.isin(lab, torch.tensor(copies, device="cuda")).any()
    torch.testing.assert_close(fk.fuzzy_normalizer(x, c),
                               fk.fuzzy_normalizer_plain(x, c),
                               rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("small_scratch", [False, True])
@pytest.mark.parametrize("spread", [1.0, 30.0])
@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128),
                                   ((1 << 16) + 37, 300, 19), (3001, 70, 130)])
def test_b9_matches_plain(gen, n, k, d, spread, small_scratch, monkeypatch):
    # The ragged shapes mask rows, components and columns; d = 19 takes
    # the scalar loads, d = 130 two column slices of x and two of x².
    # Variances and weights are the hard-assignment moments, as a fit
    # starts from; spread 30 widens the variances so the responsibilities
    # of a row spread over several components.
    if small_scratch:
        monkeypatch.setattr(fk, "MU_SCRATCH_BYTES", SMALL_SCRATCH)
    x, c = _data(gen, n, k, d)
    var, w = tgmm._moments_from_hard_assign(x, c, 1e-6)
    var = var * spread
    st = gk.gmm_stats_fused(x, c, var, w)
    again = gk.gmm_stats_fused(x, c, var, w)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    want = gk.gmm_stats_fused_plain(x, c, var, w)
    r = tgmm.gmm_predict_proba(x, tgmm.GMMResult(
        c, var, w, 0, torch.zeros(()), False))
    scale = r.T @ x.abs()  # Σr|x|
    assert ((st.sx - want.sx).abs() <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(st.sxx, want.sxx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st.nk, want.nk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st.ll_sum, want.ll_sum, rtol=1e-5, atol=0.0)


def test_b9_fit_matches_plain_fit(gen):
    x, c = _data(gen, 20000, 64, 32)
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    before = gk.gmm_stats_fused.launches
    a = tgmm.gmm_fit(x, 64, init=init, max_iters=30, tol=1e-4,
                     kernel="pallas")
    assert gk.gmm_stats_fused.launches == before + a.n_iter + 1
    b = tgmm.gmm_fit(x, 64, init=init, max_iters=30, tol=1e-4, kernel="xla")
    assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
    torch.testing.assert_close(a.means, b.means, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(a.log_likelihood, b.log_likelihood,
                               rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(1000, 37, 19), (5000, 130, 128),
                                   ((1 << 16) + 37, 300, 19),
                                   (3000, 70, 200)])
def test_b5_matches_plain(gen, n, k, d, dtype):
    # d = 19 takes the scalar loads and pads the product to 32 columns;
    # d = 200 takes two staged chunks of d per K tile.
    x, c = _data(gen, n, k, d)
    x = x.to(dtype)
    st, lab = lk.lloyd_stats_fused_bf16(x, c, return_labels=True)
    again = lk.lloyd_stats_fused_bf16(x, c)
    assert all(torch.equal(a, b) for a, b in zip(st, again))
    want, plab = lk.lloyd_stats_fused_bf16_plain(x, c, return_labels=True)
    assert torch.equal(lab, plab)
    assert torch.equal(st.counts, want.counts)
    torch.testing.assert_close(st.sums, want.sums, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st.sse, want.sse, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("d", [19, 128])
def test_b5_bf16_ties_go_to_the_smallest_index(gen, d):
    k, copies = 300, [5, 67, 200, 299]
    x, c = _data(gen, 4000, k, d)
    c = c.to(torch.bfloat16).float()
    c[copies] = c[3] * (1 + 2.0 ** -10)  # other f32 values, same bf16
    assert not torch.equal(c[copies[0]], c[3])
    assert torch.equal(c[copies].to(torch.bfloat16),
                       c[3].expand(len(copies), d).to(torch.bfloat16))
    xb = x.to(torch.bfloat16)
    st, lab = lk.lloyd_stats_fused_bf16(xb, c, return_labels=True)
    _, plab = lk.lloyd_stats_fused_bf16_plain(xb, c, return_labels=True)
    assert torch.equal(lab, plab)
    assert not torch.isin(lab, torch.tensor(copies, device="cuda")).any()
    assert not st.counts[copies].any() and not st.sums[copies].any()


def test_b5_fit_matches_the_plain_fit(gen):
    x, c = _data(gen, 20000, 64, 32)
    xb = x.to(torch.bfloat16)
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    before = lk.lloyd_stats_fused_bf16.launches
    a = tkm.kmeans_fit(xb, 64, init=init, max_iters=30, tol=1e-4,
                       kernel="pallas")
    assert lk.lloyd_stats_fused_bf16.launches == before + a.n_iter + 1
    b = tkm.kmeans_fit(xb.cpu(), 64, init=init.cpu(), max_iters=30,
                       tol=1e-4, kernel="pallas", device="cpu")
    assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
    torch.testing.assert_close(a.centroids.cpu(), b.centroids, rtol=0.0,
                               atol=1e-4)


# The edges of B5's tensor-core design: K = 1; K below the 256-centroid
# tile and not a multiple of 8; K·d at FUSED_MAX_KD; d = 8 (one k-step of
# a 64-column block); d = 200 (one 256-column chunk of x, four column
# blocks, the last partial); d = 300 (two chunks, x restaged per K tile);
# N = 1; a misaligned base (the scalar path).
B5_CASES = {
    "k1": (2000, 1, 64),
    "k37": (3001, 37, 64),
    "kd_at_limit": (5000, 4096, 128),
    "d8": (3001, 37, 8),
    "d200": (3000, 70, 200),
    "d300_two_chunks": (2000, 70, 300),
    "n1": (1, 37, 19),
    "n1_d128": (1, 300, 128),
    "misaligned": (3001, 130, 128),
}


def _check_b5(x, c):
    """B5 against its plain version: two runs bitwise equal; labels equal
    to the plain version's but at near-ties in B5's own metric (c2 −
    2·x̃·c̃ on the bf16-rounded operands, in f64: within 1e-5 of ‖x̃‖² +
    max ‖c̃‖²); counts equal where the labels agree; sums within 1e-5 of
    Σ|x| against f64 sums by the kernel's own labels; SSE within rtol
    1e-5."""
    k = c.shape[0]
    st, lab = lk.lloyd_stats_fused_bf16(x, c, return_labels=True)
    again, lab2 = lk.lloyd_stats_fused_bf16(x, c, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip((*st, lab),
                                                 (*again, lab2)))
    want, plab = lk.lloyd_stats_fused_bf16_plain(x, c, return_labels=True)
    other = lab != plab
    diff = other.nonzero().flatten()
    if diff.numel():
        cb, c2 = lk._bf16_operands(x, c)
        xr, cr = x[diff].to(torch.bfloat16).double(), cb.double()

        def value(lb):
            j = lb[diff].long()
            return c2[j].double() - 2.0 * (xr * cr[j]).sum(1)

        scale = (xr * xr).sum(1) + (cr * cr).sum(1).max()
        assert ((value(lab) - value(plab)).abs() <= 1e-5 * scale).all()

    def bincount(lb):
        return torch.bincount(lb.long(), minlength=k).to(torch.float32)

    assert torch.equal(st.counts - want.counts,
                       bincount(lab[other]) - bincount(plab[other]))
    xd = x.double()
    ref = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                      device="cuda").index_add_(0, lab.long(), xd)
    scale = torch.zeros_like(ref).index_add_(0, lab.long(), xd.abs())
    assert ((st.sums.double() - ref).abs() <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(st.sse, want.sse, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(B5_CASES))
def test_b5_tensor_core_design_edges(gen, case, dtype):
    n, k, d = B5_CASES[case]
    x, c = _data(gen, n, k, d)
    x = _rows(x.to(dtype).contiguous(), case == "misaligned")
    before = lk.lloyd_stats_fused_bf16.launches
    _check_b5(x, c)
    assert lk.lloyd_stats_fused_bf16.launches == before + 2


def _tall(gen, n, k, d):
    x, c = _data(gen, n, k, d)
    return x.T.contiguous(), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d", [(1000, 15, 5), (2000, 30, 2),
                                   (3000, 8, 11), (1000, 37, 19),
                                   (3000, 130, 128)])
def test_b10_b11_match_plain(gen, n, k, d, dtype):
    xt, c = _tall(gen, n, k, d)
    xt = xt.to(dtype)
    st, lab = tt.lloyd_stats_tall(xt, c, return_labels=True)
    again, lab2 = tt.lloyd_stats_tall(xt, c, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip((*st, lab), (*again, lab2)))
    want, plab = tt.lloyd_stats_tall_plain(xt, c, return_labels=True)
    assert torch.equal(lab, plab) and torch.equal(st.counts, want.counts)
    torch.testing.assert_close(st.sums, want.sums, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st.sse, want.sse, rtol=1e-5, atol=1e-4)
    cr, c2 = tt._operands(xt, c)
    for m in (2.0, 1.7):
        f = tt.fuzzy_stats_tall(xt, c, m)
        assert all(torch.equal(a, b)
                   for a, b in zip(f, tt.fuzzy_stats_tall(xt, c, m)))
        pf = tt.fuzzy_stats_tall_plain(xt, c, m)
        xf = xt.float()
        scale = tt.tall_memberships(xf, cr, c2, m)[0] @ xf.abs().T  # Σμ|x|
        assert ((f.weighted_sums - pf.weighted_sums).abs()
                <= 1e-5 * scale + 1e-6).all()
        torch.testing.assert_close(f.weights, pf.weights, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(f.objective, pf.objective, rtol=1e-5,
                                   atol=0.0)


@pytest.mark.parametrize("k,d", [(15, 5), (300, 19)])
def test_b10_b11_ties(gen, k, d):
    xt, c = _tall(gen, 4000, k, d)
    copies = [5, 9, k - 1]
    c[copies] = c[3].clone()
    st, lab = tt.lloyd_stats_tall(xt, c, return_labels=True)
    assert torch.equal(lab, tt.lloyd_stats_tall_plain(xt, c,
                                                      return_labels=True)[1])
    assert not st.counts[copies].any() and not st.sums[copies].any()
    f = tt.fuzzy_stats_tall(xt, c, 2.0)
    for j in copies:
        assert torch.equal(f.weights[j], f.weights[3])
        assert torch.equal(f.weighted_sums[j], f.weighted_sums[3])


def test_tall_fits_match_the_plain_fits(gen):
    xt, c = _tall(gen, 20000, 15, 5)
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    for fit, wrapper, kw in ((tkm.kmeans_fit, tt.lloyd_stats_tall, {}),
                             (tfz.fuzzy_cmeans_fit, tt.fuzzy_stats_tall,
                              {"m": 2.0})):
        before = wrapper.launches
        a = fit(xt, 15, init=init, max_iters=30, tol=1e-4,
                layout="features", **kw)
        assert wrapper.launches == before + a.n_iter + 1
        b = fit(xt.cpu(), 15, init=init.cpu(), max_iters=30, tol=1e-4,
                layout="features", device="cpu", **kw)
        assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
        torch.testing.assert_close(a.centroids.cpu(), b.centroids,
                                   rtol=0.0, atol=1e-4)


# The edges of B11's private form (d <= 8, K·(d+1) <= 96; its μᵀ·X on the
# tensor cores in (m16, n8) tiles): d = 1 and 8; K = 1, 15 and 16;
# K·(d+1) = 96 at K = 16, d = 5 (the route's d) and at K = 48, d = 1
# (three m16 tiles); d = 7 (the ones column fills the n8 tile) and d = 8
# (the ones column in a second n8 tile). K·(d+1) = 97 (K = 1, d = 96) and
# 98 (K = 49, d = 1) take the tile form. N is ragged (no multiple of the
# 256-column tile) throughout.
B11_CASES = {
    "d1_k1": (3001, 1, 1),
    "d1_k48_kd96": (3001, 48, 1),
    "d5_k15": (5003, 15, 5),
    "d5_k16_kd96": (5003, 16, 5),
    "d7_k12_kd96": (3001, 12, 7),
    "d8_k1": (3001, 1, 8),
    "d8_k10": (3001, 10, 8),
    "tile_kd97": (3001, 1, 96),
    "tile_kd98": (3001, 49, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2.0, 1.7])
@pytest.mark.parametrize("case", list(B11_CASES))
def test_b11_private_form_edges(gen, case, m, dtype):
    # As test_b10_b11_match_plain; where K > 2, copies of centroid 1 at
    # index 2 and K-1 take its Σμx and Σμ, bitwise.
    n, k, d = B11_CASES[case]
    xt, c = _tall(gen, n, k, d)
    copies = [2, k - 1] if k > 3 else []
    if copies:
        c[copies] = c[1].clone()
    xt = xt.to(dtype)
    before = tt.fuzzy_stats_tall.launches
    f = tt.fuzzy_stats_tall(xt, c, m)
    assert all(torch.equal(a, b)
               for a, b in zip(f, tt.fuzzy_stats_tall(xt, c, m)))
    assert tt.fuzzy_stats_tall.launches == before + 2
    pf = tt.fuzzy_stats_tall_plain(xt, c, m)
    cr, c2 = tt._operands(xt, c)
    xf = xt.float()
    scale = tt.tall_memberships(xf, cr, c2, m)[0] @ xf.abs().T  # Σμ|x|
    assert ((f.weighted_sums - pf.weighted_sums).abs()
            <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(f.weights, pf.weights, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(f.objective, pf.objective, rtol=1e-5,
                               atol=0.0)
    for j in copies:
        assert torch.equal(f.weights[j], f.weights[1])
        assert torch.equal(f.weighted_sums[j], f.weighted_sums[1])


# The edges of B10's streaming form (d <= 8, K·(d+1) <= 144; one CTA per
# SM, 8 or 12 consumer warps streaming tiles of 128 columns a warp through
# a ring of shared-memory slots; tt.lloyd_plan): N = 1, N = 1000 (one
# partial tile), one column past a tile (a ring slot) with 12 and with 8
# warps, N % 8 != 0 (every row but the first misaligned for the bulk
# copies, the last tiles read directly), a base one element past a 16-byte
# boundary (the first tile read directly), N past slots × SMs tiles (each
# CTA's ring wraps: 2 slots at K = 15, d = 5 on f32 columns, 5 on bf16);
# d = 1 to 8 at K = 144 // (d+1), the form's limit, K = 1, K % 4 = 1, 2,
# 3 (the last group's sizes), and K·(d+1) = 153 on the tile form.
B10_CASES = {
    "n1": (1, 15, 5, False),
    "n1000": (1000, 15, 5, False),
    "past_one_slot": (tt.lloyd_plan(15, 5, 4).tile_cols + 1, 15, 5, False),
    "past_one_slot_8_warps": (tt.lloyd_plan(16, 8, 4).tile_cols + 1, 16, 8,
                              False),
    "misaligned_rows": (4099, 15, 5, False),
    "misaligned_base": (5003, 15, 5, True),
    "ring_wraps": ((1 << 21) + 5, 15, 5, False),
    "k1": (3001, 1, 5, False),
    "k2_d8": (3001, 2, 8, False),
    "k3": (3001, 3, 3, False),
    **{f"d{d}_limit": (3001, 144 // (d + 1), d, False) for d in range(1, 9)},
    "tile_kd153": (3001, 17, 8, False),
}


def _check_b10(xt, c):
    """B10 against its plain version: two runs bitwise equal; labels equal
    to the plain version's but at near-ties in B10's own metric (d² of the
    columns and the centroids as the kernel sees them, in f64: within 1e-5
    of ‖x‖² + max ‖c‖²); counts equal where the labels agree; sums within
    1e-5 of Σ|x| against f64 sums by the kernel's own labels; SSE within
    rtol 1e-5."""
    k = c.shape[0]
    st, lab = tt.lloyd_stats_tall(xt, c, return_labels=True)
    again, lab2 = tt.lloyd_stats_tall(xt, c, return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip((*st, lab),
                                                 (*again, lab2)))
    want, plab = tt.lloyd_stats_tall_plain(xt, c, return_labels=True)
    other = lab != plab
    diff = other.nonzero().flatten()
    xd = xt.double().T
    if diff.numel():
        cr = tt._operands(xt, c)[0].double()

        def value(lb):
            return ((xd[diff] - cr[lb[diff].long()]) ** 2).sum(1)

        scale = (xd[diff] ** 2).sum(1) + (cr * cr).sum(1).max()
        assert ((value(lab) - value(plab)).abs() <= 1e-5 * scale).all()

    def bincount(lb):
        return torch.bincount(lb.long(), minlength=k).to(torch.float32)

    assert torch.equal(st.counts - want.counts,
                       bincount(lab[other]) - bincount(plab[other]))
    ref = torch.zeros((k, xt.shape[0]), dtype=torch.float64,
                      device="cuda").index_add_(0, lab.long(), xd)
    scale = torch.zeros_like(ref).index_add_(0, lab.long(), xd.abs())
    assert ((st.sums.double() - ref).abs() <= 1e-5 * scale + 1e-6).all()
    torch.testing.assert_close(st.sse, want.sse, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(B10_CASES))
def test_b10_streaming_form_edges(gen, case, dtype):
    n, k, d, misaligned = B10_CASES[case]
    xt, c = _tall(gen, n, k, d)
    xt = _rows(xt.to(dtype).contiguous(), misaligned)
    before = tt.lloyd_stats_tall.launches
    _check_b10(xt, c)
    assert tt.lloyd_stats_tall.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,misaligned", [(4096, False), (4099, False),
                                          (5003, True)])
def test_b10_stream_only_reads_every_column_once(gen, n, misaligned, dtype):
    # The timing instrument: the kernel takes the columns and adds Σx² of
    # the live ones, so its SSE is Σ‖x‖² over the N columns (each read once,
    # from its own place in the ring or in device memory).
    xt, c = _tall(gen, n, 15, 5)
    xt = _rows(xt.to(dtype).contiguous(), misaligned)
    st, _ = tt._launch_lloyd(xt, c, stream_only=True)
    torch.testing.assert_close(st.sse.double(),
                               (xt.double() ** 2).sum(), rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(24, 5), (16, 8), (72, 1)])
def test_b10_streaming_form_ties(gen, k, d, dtype):
    # Copies of centroid 3 (the last of the first group of 4) in the next
    # groups and in the last one: every tie goes to the smallest index, so
    # the copies take no columns.
    xt, c = _tall(gen, 5003, k, d)
    copies = [4, 7, 9, k - 1]
    c[copies] = c[3].clone()
    xt = xt.to(dtype)
    st, lab = tt.lloyd_stats_tall(xt, c, return_labels=True)
    assert torch.equal(lab, tt.lloyd_stats_tall_plain(xt, c,
                                                      return_labels=True)[1])
    assert not st.counts[copies].any() and not st.sums[copies].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(15, 5), (16, 8), (3, 1)])
def test_b10_columns_on_centroids_take_the_exact_path(gen, k, d, dtype):
    # A column equal to a centroid has d² = 0 up to rounding, where the
    # streaming form's unclamped minimum may be ≤ 0: those columns are
    # scored again with the clamp, so copies of a centroid still lose to
    # it and the labels are the plain version's. Columns with x2 past
    # 1e38 − max ‖c‖² take the same path.
    xt, c = _tall(gen, 4099, k, d)
    if k > 2:
        c[k - 1] = c[1].clone()
    c = c.to(dtype).float()  # exact in either dtype
    on = torch.arange(0, xt.shape[1], 3, device="cuda")
    xt[:, on] = c.T[:, on % k]
    xt[:, 7] = 1e19  # x2 = d·1e38, past the limit
    xt = xt.to(dtype)
    st, lab = tt.lloyd_stats_tall(xt, c, return_labels=True)
    plab = tt.lloyd_stats_tall_plain(xt, c, return_labels=True)[1]
    assert torch.equal(lab[on], plab[on])
    want = torch.where(on % k == k - 1, 1, on % k) if k > 2 else on % k
    assert torch.equal(lab[on].long(), want)
    if k > 2:
        assert st.counts[k - 1] == 0


# The streamed fits on the card against the same fits on the CPU (the
# kernels' plain versions), 7 batches with a ragged last one, from the
# same explicit init: equal n_iter and converged, centroids (means) within
# 1e-4, the cost within rtol 1e-5; each kernel launches once per batch of
# each pass.
def test_streamed_fits_on_the_card_match_the_cpu(gen):
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.models import streaming as tst

    x, c = _data(gen, 7000, 37, 19)
    init = (c + 0.3 * torch.randn(c.shape, generator=gen,
                                  device="cuda")).cpu()
    host = x.cpu().numpy()
    cases = (
        (tst.streamed_kmeans_fit, lk.lloyd_stats_fused, {}, "sse"),
        (tst.streamed_fuzzy_fit, fk.fuzzy_stats_fused, {"m": 2.0},
         "objective"),
        (tgmm.streamed_gmm_fit, gk.gmm_stats_fused,
         {"covariance_type": "diag"}, "log_likelihood"),
    )
    for fit, wrapper, kw, cost in cases:
        before = wrapper.launches
        a = fit(NpzStream(host, 1100), 37, 19, init=init, max_iters=30,
                tol=1e-4, kernel="pallas", **kw)
        assert wrapper.launches == before + 7 * a.comms.passes
        b = fit(NpzStream(host, 1100), 37, 19, init=init, max_iters=30,
                tol=1e-4, kernel="pallas", device="cpu", **kw)
        assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
        ca = a.means if hasattr(a, "means") else a.centroids
        cb = b.means if hasattr(b, "means") else b.centroids
        torch.testing.assert_close(ca.cpu(), cb, rtol=0.0, atol=1e-4)
        torch.testing.assert_close(getattr(a, cost).cpu().float(),
                                   getattr(b, cost).float(), rtol=1e-5,
                                   atol=0.0)


def test_oom_retry_frees_the_failed_attempt(gen):
    """A real CUDA out-of-memory error in the first attempt: the retry
    runs with twice the batches and finds the card's allocated memory
    back at its level before the fit."""
    from tdc_tpu_torch.data.batching import oom_adaptive

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    seen = []

    def run(num_batches):
        held = torch.empty(1 << 28, device="cuda")  # 1 GiB of leftovers
        seen.append(torch.cuda.memory_allocated())
        if num_batches == 1:
            total = torch.cuda.get_device_properties(0).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        del held
        return num_batches

    assert oom_adaptive(run) == (2, 2)
    assert seen[1] == seen[0]
    assert torch.cuda.memory_allocated() == start


def test_cli_oom_retry_frees_the_in_memory_copy(gen, tmp_path, monkeypatch):
    """A --data_file fit whose in-memory fit runs out of memory after the
    CLI copied the points to the card: the streamed retry starts with the
    card's allocated memory back at its level before the fit, and the
    computation fit after it holds no copy of the points either."""
    import numpy as np

    import tdc_tpu_torch.models as tmodels
    from tdc_tpu_torch.cli import main as tcli

    x, _ = _data(gen, 1 << 20, 37, 64)  # 256 MiB of points
    path = tmp_path / "x.npy"
    np.save(path, x.cpu().numpy())
    del x
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    real_stream = tmodels.streamed_kmeans_fit
    on_card, at_retry = [], []

    def oom_fit(xx, *a, **kw):
        on_card.append(xx.device.type)
        total = torch.cuda.get_device_properties(0).total_memory
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")

    def stream_fit(*a, **kw):
        torch.cuda.synchronize()
        at_retry.append(torch.cuda.memory_allocated())
        return real_stream(*a, **kw)

    monkeypatch.setattr(tmodels, "kmeans_fit", oom_fit)
    monkeypatch.setattr(tmodels, "streamed_kmeans_fit", stream_fit)
    log = tmp_path / "oom.csv"
    assert tcli.main(["--K=37", "--init=first_k", "--tol=-1",
                      "--n_max_iters=2", "--kernel=pallas",
                      f"--data_file={path}", f"--log_file={log}"]) == 0
    assert on_card == ["cuda"]
    # The computation fit's start holds the first fit's result, a few KiB.
    assert at_retry[0] == start
    assert 0 <= at_retry[1] - start < (1 << 20)


# ROADMAP.md "To probe": B10's tile form (K·(d+1) > 144) rounds its
# per-CTA sums in f32. A features-layout fit on the tile form against the
# same fit on the CPU: equal n_iter and converged, centroids within 1e-4.
def test_tall_fit_on_the_tile_form_matches_the_plain_fit(gen):
    xt, c = _tall(gen, 200000, 17, 8)
    init = c + 0.3 * torch.randn(c.shape, generator=gen, device="cuda")
    before = tt.lloyd_stats_tall.launches
    a = tkm.kmeans_fit(xt, 17, init=init, max_iters=50, tol=1e-4,
                       layout="features")
    assert tt.lloyd_stats_tall.launches == before + a.n_iter + 1
    b = tkm.kmeans_fit(xt.cpu(), 17, init=init.cpu(), max_iters=50,
                       tol=1e-4, layout="features", device="cpu")
    assert (a.n_iter, a.converged) == (b.n_iter, b.converged)
    torch.testing.assert_close(a.centroids.cpu(), b.centroids, rtol=0.0,
                               atol=1e-4)


# The model zoo on the card (no new kernel: B1 and B4 carry the mini-batch
# steps, k-means‖ and bisecting run on plain ops). k-means‖: K distinct
# rows, bitwise repeats, the same seeds as on the CPU from the same draws.
def test_kmeans_parallel_on_the_card(gen, monkeypatch):
    from tdc_tpu_torch.ops import kmeans_parallel as tkp

    x, _ = _data(gen, 5000, 37, 19)
    runs = [tkp.init_kmeans_parallel(
        torch.Generator(device="cuda").manual_seed(3), x, 37)
        for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert len({tuple(r) for r in runs[0].cpu().tolist()}) == 37
    # The CPU run fed the card run's draws picks the same rows (the
    # products differ in their last bits only).
    draws = []
    real = tkp._draw
    monkeypatch.setattr(tkp, "_draw", lambda *a: draws.append(real(*a))
                        or draws[-1])
    card = tkp.init_kmeans_parallel(
        torch.Generator(device="cuda").manual_seed(3), x, 37)
    it = iter(draws)
    monkeypatch.setattr(tkp, "_draw", lambda *a: next(it).cpu())
    cpu = tkp.init_kmeans_parallel(torch.Generator(), x.cpu(), 37)
    assert torch.equal(card.cpu(), cpu)


# Mini-batch steps on B1 and B4: the stats route launches once a step;
# the state matches the CPU step (the kernels' plain versions) within
# 1e-4, the counts exactly.
@pytest.mark.parametrize("weighted", [False, True])
def test_minibatch_steps_on_the_kernels(gen, weighted):
    from tdc_tpu_torch.models import minibatch as tmb

    x, c = _data(gen, 6000, 37, 19)
    w = (torch.rand(6000, generator=gen, device="cuda") * 2
         if weighted else None)
    fn = lk.lloyd_stats_fused_weighted if weighted else lk.lloyd_stats_fused
    states = {}
    for dev in ("cuda", "cpu"):
        st = tmb.MiniBatchState(c.to(dev).clone(), torch.zeros(37,
                                                               device=dev),
                                0, torch.tensor(float("inf"), device=dev))
        before = fn.launches
        for s in range(0, 6000, 2000):
            st = tmb.minibatch_step(
                st, x[s:s + 2000].to(dev), sample_weight=(
                    None if w is None else w[s:s + 2000].to(dev)),
                kernel="pallas")
        assert fn.launches == before + (3 if dev == "cuda" else 0)
        states[dev] = st
    a, b = states["cuda"], states["cpu"]
    torch.testing.assert_close(a.centroids.cpu(), b.centroids, rtol=0.0,
                               atol=1e-4)
    torch.testing.assert_close(a.counts.cpu(), b.counts, rtol=1e-5,
                               atol=1e-4)


# Bisecting on the card: bitwise repeats, and the CPU fit's labels.
def test_bisecting_on_the_card(gen):
    from tdc_tpu_torch.models import bisecting as tbis

    x, _ = _data(gen, 4000, 6, 5)
    fits = [tbis.bisecting_kmeans_fit(
        x, 6, generator=torch.Generator(device="cuda").manual_seed(1),
        return_labels=True) for _ in range(2)]
    assert torch.equal(fits[0][0].centroids, fits[1][0].centroids)
    assert (fits[0][1] == fits[1][1]).all()
    assert int(fits[0][0].n_iter) >= 5


def test_residency_on_the_card_is_bitwise_the_stream(gen, monkeypatch):
    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.data import spill as tsp
    from tdc_tpu_torch.models import streaming as tst

    x, c = _data(gen, 7000, 37, 19)
    host = x.cpu().numpy()
    init = c.cpu()
    pinned, streams = [], []
    real_put = tsp._PinnedCopies.put_fn

    def watched(self, slot):
        put = real_put(self, slot)

        def checked(a, rows):
            out = put(a, rows)
            pinned.extend(b.is_pinned() for b in self.buffers.values())
            streams.append(self.streams[slot] != torch.cuda.current_stream())
            return out

        return checked

    monkeypatch.setattr(tsp._PinnedCopies, "put_fn", watched)
    for fit, wrapper, kw, cost in (
            (tst.streamed_kmeans_fit, lk.lloyd_stats_fused, {}, "sse"),
            (tst.streamed_fuzzy_fit, fk.fuzzy_stats_fused, {"m": 2.0},
             "objective")):
        runs = {}
        for residency in ("stream", "hbm", "spill"):
            before = wrapper.launches
            runs[residency] = fit(NpzStream(host, 1100), 37, 19, init=init,
                                  max_iters=6, tol=-1.0, kernel="pallas",
                                  residency=residency, **kw)
            assert wrapper.launches == before + 7 * 7  # 6 iterations + 1
        for residency in ("hbm", "spill"):
            a, b = runs[residency], runs["stream"]
            assert torch.equal(a.centroids, b.centroids)
            assert torch.equal(getattr(a, cost), getattr(b, cost))
            assert (a.history == b.history).all()
        assert runs["spill"].h2d.batches >= 7 * 7
    assert pinned and all(pinned) and streams and all(streams)


def test_data_plane_on_the_card_quarantines_as_removed(gen, tmp_path):
    """The ingest guard with the scan on the card: a CRC-bad batch of a
    manifest and a NaN batch of an NpzStream are quarantined, and the
    K-Means (B1) and fuzzy (B6) fits are bitwise the fits with that batch
    removed; the native loader's fit is bitwise the NpzStream fit."""
    import numpy as np

    from tdc_tpu_torch.data import NpzStream
    from tdc_tpu_torch.data.ingest import IngestPolicy
    from tdc_tpu_torch.data.manifest import build_manifest
    from tdc_tpu_torch.data.native_loader import NativePrefetchStream
    from tdc_tpu_torch.data.store import open_manifest_stream
    from tdc_tpu_torch.models import streaming as tst

    x, c = _data(gen, 7000, 37, 19)
    host = x.cpu().numpy()
    init = c.cpu()
    mdir = str(tmp_path / "blobs")
    build_manifest(host, 1000, mdir)
    raw = bytearray(open(f"{mdir}/part-00000.bin", "rb").read())
    raw[3 * 1000 * 19 * 4 + 5] ^= 0x10  # batch 3
    open(f"{mdir}/part-00000.bin", "wb").write(bytes(raw))
    nan = host.copy()
    nan[3000:4000:7, 2] = np.nan

    def without_3():
        for i in (0, 1, 2, 4, 5, 6):
            yield host[i * 1000:(i + 1) * 1000]

    policy = IngestPolicy(max_bad_fraction=0.2)
    for fit, kw, cost in ((tst.streamed_kmeans_fit, {}, "sse"),
                          (tst.streamed_fuzzy_fit, {"m": 2.0}, "objective")):
        common = dict(init=init, max_iters=4, tol=-1.0, kernel="pallas",
                      **kw)
        want = fit(without_3, 37, 19, **common)
        for stream in (open_manifest_stream(mdir), NpzStream(nan, 1000)):
            got = fit(stream, 37, 19, ingest=policy, **common)
            assert torch.equal(got.centroids, want.centroids)
            assert torch.equal(getattr(got, cost), getattr(want, cost))
            assert got.ingest.quarantined_batches == 1
    p = str(tmp_path / "x.npy")
    np.save(p, host)
    a = tst.streamed_kmeans_fit(NpzStream(host, 1000), 37, 19, init=init,
                                max_iters=3, tol=-1.0, kernel="pallas")
    for residency in ("stream", "spill"):
        b = tst.streamed_kmeans_fit(NativePrefetchStream(p, 1000), 37, 19,
                                    init=init, max_iters=3, tol=-1.0,
                                    kernel="pallas", residency=residency)
        assert torch.equal(a.centroids, b.centroids)
