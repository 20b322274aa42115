"""Where the time of B1 and B4 goes on one NVIDIA GPU, and what their
3xTF32 distance product does to their answers, beside an earlier design.

    python3 scripts/b1_b4_phases.py [--out DIR] [--parent TREE]
                                    [--builds NAME,...]

B1 (`lloyd_stats_fused`) and B4 (`lloyd_stats_fused_weighted`) of the
PyTorch/CUDA port share one kernel, `lloyd_fused_tc_kernel` in
tdc_tpu_torch/csrc/lloyd_kernels.cu: per 128-row block the distance
product on the tensor cores (3xTF32) and the champion fold, then the
accumulate of the block's rows into the CTA's workspace slice. The
script runs, each in its own process with its own build, these builds:

- full: the kernels as they are;
- no_accumulate: without the accumulate warps' work (the grouping of
  each block's rows by label, their sums and SSE terms): the product,
  the fold and the hand-over of the labels are left;
- mma_sync: the same kernel with its 3xTF32 product issued as
  `mma.sync` m16n8k8 (the helpers in csrc/tf32_accum.cuh) on the same
  shared-memory tiles instead of `wgmma` (an alternative form, timed and
  checked, not kept);
- one_tf32: the control: the product as one TF32 pass (x_hi·c_hi only,
  the two correction products dropped), checked only: the near-tie
  input's labels must then differ from the plain version's beyond a
  near-tie (`far` > 0), which is what fails it in chip_smoke.py and the
  card tests;
- parent (with --parent TREE, the tdc_tpu_torch/ of an earlier commit,
  e.g. unpacked with `git archive <commit> tdc_tpu_torch`): as it is;
- parent_no_accumulate and parent_no_norm: the earlier design
  (`lloyd_fused_kernel`, the product on the f32 FMA pipe) without its
  accumulate loop, and also without its ‖x‖² read and SSE loop.

Every build times (`time`) B1 and B4 at N=2^22, K=1024, d=128 on the
smoke run's blobs (B4 with its weights: uniform in [0, 3), ~5% zero), and
the fixed cost: the parent's calls with no rows (`n0`: the workspace
zeroing and the slice reduce at its grid, which does not depend on N),
the full design's with one 128-row block per CTA (`one_block`: the
centroid pre-pass, the zeroing, one block's product and accumulate and
the reduce). So for either design full − no_accumulate is what the
accumulate adds (the full design runs it beside the next block's
product), and for the parent ‖x‖² and SSE = no_accumulate − no_norm,
product and fold = no_norm − n0. The full and parent builds also run
`checks`: B1 and B4 against their plain versions on the smoke run's
shapes, the card tests' shapes, duplicated centroids and a near-tie
input (points off the bisector of two centroids by offsets log-uniform
over 1e-6..10^-2.5 a coordinate, so that the true gaps straddle the
near-tie limit), reporting for each case the labels that differ from
the plain version's (`near_ties`; all must be near-ties: within 1e-5 of
‖x‖² + max ‖c‖² in f64, `far` counts those that are not), the largest
true gap among them as a share of that limit (`gap_share`), on the
near-tie inputs the rows whose true gap lies past the limit and within
ten times it (`past_limit`), the largest error of the sums against the
plain version's where the labels agree and against f64 sums by the
kernel's own labels, as a share of the card tolerance (1e-5 of Σ|x| or
Σw|x| per cluster), the SSE's relative error, and whether two runs are
bitwise equal. The parent's labels are those of its B2
(`distance_argmin`), which runs the same champion fold on the same f32
products.

Each build is a copy of tdc_tpu_torch/ (and chip_smoke.py) under DIR
(default scratch_trees/b1_b4_phases, which .gitignore lists), timed with
CUDA events (median of 5 after a warm-up), in the order given (default:
full, no_accumulate, mma_sync, one_tf32, then with --parent the three
parent builds, then full once more, times only; scripts/_phases.py runs
them). The cut builds compute wrong stats; only their times are read.
Prints one JSON line per run, then the card's name and power limit.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

SOURCE = "csrc/lloyd_kernels.cu"

ACCUMULATE = edit(SOURCE, spans=(
    ("      sse += accumulate_block<kVec, kWeighted>(",
     "      warp_arrive(&sm.freed[i & 1]);"),))
# The product as `mma.sync` m16n8k8 (tf32_accum.cuh's `mma_tf32`) on the
# same swizzled tiles: each warp's 16 rows times the stage's 256
# centroids as 32 n8 tiles, whose f32 fragments are laid out as `wgmma`'s
# accumulators, so the fold reads them unchanged.
WGMMA_PRODUCT = """\
          for (int kk = 0; kk < ks; ++kk) {
            const unsigned long long db = sw128_desc(cs + 8 * kk);
            wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk), db, 1);
            if (half == 0) {
              wgmma_m64n256k8_tf32(acc, sw128_desc(xl + 8 * kk), db, 1);
            }
          }
"""
MMA_SYNC_PRODUCT = """\
          for (int kk = 0; kk < ks; ++kk) {
            const int c0 = 8 * kk + t4, ra = 16 * ww + gq;
            const int at[4] = {swizzle_col(ra, c0), swizzle_col(ra + 8, c0),
                               swizzle_col(ra, c0 + 4),
                               swizzle_col(ra + 8, c0 + 4)};
            unsigned ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[e] = __float_as_uint(xh[at[e]]);
              al[e] = __float_as_uint(xl[at[e]]);
            }
#pragma unroll
            for (int nt = 0; nt < kTcBN / 8; ++nt) {
              const int nb = 8 * nt + gq;
              const unsigned b0 = __float_as_uint(cs[swizzle_col(nb, c0)]);
              const unsigned b1 =
                  __float_as_uint(cs[swizzle_col(nb, c0 + 4)]);
              float f[4] = {acc[4 * nt], acc[4 * nt + 1], acc[4 * nt + 2],
                            acc[4 * nt + 3]};
              mma_tf32(f, ah, b0, b1);
              if (half == 0) mma_tf32(f, al, b0, b1);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[4 * nt + e] = f[e];
            }
          }
"""
ONE_TF32_PRODUCT = """\
          for (int kk = 0; kk < ks; ++kk) {
            const unsigned long long db = sw128_desc(cs + 8 * kk);
            if (half == 0) {
              wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk), db, 1);
            }
          }
"""
PARENT_ACCUMULATE = edit(SOURCE, spans=(
    ("    for (int j = tid; j < cols; j += kThreads) {\n"
     "      for (int r = 0; r < rows; ++r) {",
     "    if (tid == 0) {\n      for (int r = 0; r < rows; ++r) sse +="),))
# The parent's ‖x‖² read and its SSE loop.
PARENT_NORM = edit(SOURCE, swaps=(
    ("      const float x2 = row_sq_norm(x, n, d, row);",
     "      const float x2 = 0.f;"),
    ("      for (int r = 0; r < rows; ++r) sse += (double)s_val[r];",
     "      (void)rows;")))


# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("time", "checks")),
    "no_accumulate": ("repo", ACCUMULATE, ("time",)),
    "mma_sync": ("repo", edit(SOURCE, swaps=((WGMMA_PRODUCT,
                                              MMA_SYNC_PRODUCT),)),
                 ("time", "checks")),
    "one_tf32": ("repo", edit(SOURCE, swaps=((WGMMA_PRODUCT,
                                              ONE_TF32_PRODUCT),)),
                 ("checks",)),
    "parent": ("parent", (), ("time", "checks")),
    "parent_no_accumulate": ("parent", PARENT_ACCUMULATE, ("time",)),
    "parent_no_norm": ("parent", PARENT_ACCUMULATE + PARENT_NORM,
                       ("time",)),
}

TIMER = r"""
from tdc_tpu_torch.ops import _build, lloyd_kernels as lk

REL_TOL, TIE_TOL = 1e-5, 1e-5

def blobs(gen, n, k, d):
    centers = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
    lab = torch.arange(n, device="cuda") % k
    x = torch.randn((n, d), generator=gen, device="cuda") + centers[lab]
    return x.contiguous(), centers.contiguous()

def card_data(gen, n, k, d):
    # tests/test_torch_cuda.py's inputs
    centers = torch.rand((k, d), generator=gen, device="cuda") * 6 - 3
    lab = torch.arange(n, device="cuda") % k
    x = torch.randn((n, d), generator=gen, device="cuda") + centers[lab]
    return x, centers

def near_ties(gen, n, k, d):
    # Points off the midpoint of centroids i % k and (i + 1) % k, by
    # offsets log-uniform over 1e-6..10^-2.5 a coordinate (chip_smoke.py's
    # near_tie_data).
    c = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) * 3
    a = torch.arange(n, device="cuda") % k
    x = (c[a] + c[(a + 1) % k]) / 2
    s = 10.0 ** (-6.0 + 3.5 * torch.rand((n, 1), generator=gen,
                                         device="cuda"))
    x = x + s * torch.randn((n, d), generator=gen, device="cuda")
    return x.contiguous(), c

def past_limit(x, c):
    # Rows whose two candidates' true gap lies past the near-tie limit
    # and within ten times it.
    n, k = x.shape[0], c.shape[0]
    a = torch.arange(n, device="cuda") % k
    xd, cd = x.double(), c.double()
    gap = (((xd - cd[a]) ** 2).sum(1)
           - ((xd - cd[(a + 1) % k]) ** 2).sum(1)).abs()
    lim = TIE_TOL * ((xd * xd).sum(1) + (cd * cd).sum(1).max())
    return int(((gap > lim) & (gap <= 10 * lim)).sum())

def weights(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(n, generator=g, device="cuda") * 3.0
    return torch.where(torch.rand(n, generator=g, device="cuda") < 0.05,
                       0.0, w).contiguous()

def labels_of(x, c, w):
    if hasattr(lk, "_fused_tc"):
        if w is None:
            return lk.lloyd_stats_fused(x, c, return_labels=True)
        return lk.lloyd_stats_fused_weighted(x, c, w, return_labels=True)
    st = (lk.lloyd_stats_fused(x, c) if w is None
          else lk.lloyd_stats_fused_weighted(x, c, w))
    return st, lk.distance_argmin(x, c)[0]

def reading(x, c, w=None):
    k = c.shape[0]
    st, lab = labels_of(x, c, w)
    again, _ = labels_of(x, c, w)
    plab = lk.distance_argmin_plain(x, c)[0]
    want = (lk.lloyd_stats_fused_plain(x, c) if w is None
            else lk.lloyd_stats_fused_weighted_plain(x, c, w))
    wt = torch.ones(x.shape[0], device="cuda") if w is None else w
    diff = (lab != plab).nonzero().flatten()
    far, gap_share = 0, 0.0
    if diff.numel():
        xd = x[diff].double()
        dg = ((xd - c[lab[diff].long()].double()) ** 2).sum(1)
        dw = ((xd - c[plab[diff].long()].double()) ** 2).sum(1)
        scale = (xd * xd).sum(1) + (c.double() ** 2).sum(1).max()
        share = (dg - dw).abs() / (TIE_TOL * scale)
        far, gap_share = int((share > 1).sum()), float(share.max())
    def share(got, ref, lab):
        absx = torch.zeros_like(ref).index_add_(
            0, lab.long(), (wt[:, None] * x.abs()).to(ref.dtype))
        err = (got.double() - ref.double()).abs()
        return float(err.max()), float((err / (REL_TOL * absx.double()
                                                + 1e-6)).max())
    own = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                      device="cuda").index_add_(
        0, lab.long(), wt[:, None].double() * x.double())
    out = {"near_ties": int(diff.numel()), "far": far,
           "gap_share": gap_share,
           "repeatable": all(torch.equal(a, b) for a, b in zip(st, again)),
           "sse_rel": float((st.sse.double() - want.sse.double()).abs()
                            / want.sse.double().abs().clamp_min(1e-30))}
    out["sums_err_own"], out["sums_share_own"] = share(st.sums, own, lab)
    if not diff.numel():
        out["counts_equal"] = bool(torch.equal(st.counts, want.counts)
                                   if w is None else True)
        out["sums_err"], out["sums_share"] = share(st.sums, want.sums, plab)
        if w is not None:
            out["mass_rel"] = float(((st.counts - want.counts).abs()
                                     / want.counts.abs().clamp_min(1e-30)
                                     ).max())
    return out

t0 = time.perf_counter()
_build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
gen = torch.Generator(device="cuda").manual_seed(0)
n, k, d = 1 << 22, 1024, 128
x, c = blobs(gen, n, k, d)
w = weights(n, 1)
if "time" in runs:
    out["b1_ms"] = median_ms(lambda: lk.lloyd_stats_fused(x, c))
    out["b4_ms"] = median_ms(lambda: lk.lloyd_stats_fused_weighted(x, c, w))
    if hasattr(lk, "fused_tc_grid"):  # one 128-row block per CTA
        m = 128 * torch.cuda.get_device_properties(0).multi_processor_count
        out["b1_one_block_ms"] = median_ms(
            lambda: lk.lloyd_stats_fused(x[:m], c))
        out["b4_one_block_ms"] = median_ms(
            lambda: lk.lloyd_stats_fused_weighted(x[:m], c, w[:m]))
    else:  # no rows: the grid does not depend on N
        out["b1_n0_ms"] = median_ms(lambda: lk.lloyd_stats_fused(x[:0], c))
        out["b4_n0_ms"] = median_ms(
            lambda: lk.lloyd_stats_fused_weighted(x[:0], c, w[:0]))
    print(json.dumps(out), flush=True)
if "checks" in runs:
    chk = {"route": reading(x, c), "route_weighted": reading(x, c, w)}
    del x, w
    for name, (n, k, d) in {"1000x37x19": (1000, 37, 19),
                            "5000x130x128": (5000, 130, 128),
                            "3001x130x130": (3001, 130, 130),
                            "2000x70x769": (2000, 70, 769),
                            "16387x4064x128": ((1 << 14) + 3, 4064, 128),
                            "100x37x19": (100, 37, 19),
                            "ragged": ((1 << 16) + 37, 300, 19)}.items():
        xs, cs = card_data(gen, n, k, d)
        chk[name] = reading(xs, cs)
        chk[name + "_weighted"] = reading(xs, cs, weights(n, 2))
    for dd in (19, 128):
        xs, cs = card_data(gen, 4000, 300, dd)
        cs[[5, 67, 200, 299]] = cs[3].clone()
        chk[f"ties_d{dd}"] = reading(xs, cs)
        chk[f"ties_d{dd}_weighted"] = reading(xs, cs, weights(4000, 3))
    for name, (n, k, d) in {"near_ties": (1 << 16, 1024, 128),
                            "near_ties_ragged": ((1 << 16) + 37, 300, 19)
                            }.items():
        xs, cs = near_ties(gen, n, k, d)
        chk[name] = reading(xs, cs)
        chk[name]["past_limit"] = past_limit(xs, cs)
        chk[name + "_weighted"] = reading(xs, cs, weights(n, 4))
    print(json.dumps({"build": build, "checks": chk}), flush=True)
"""



if __name__ == "__main__":
    sys.exit(main("b1_b4_phases", BUILDS, TIMER,
                  ["full", "no_accumulate", "mma_sync", "one_tf32"],
                  ["parent", "parent_no_accumulate", "parent_no_norm"],
                  reps=5))
