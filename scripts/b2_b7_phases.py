"""Where the time of B2 and B7 goes on one NVIDIA GPU, and what their
3xTF32 distance product does to their answers, beside an earlier design.

    python3 scripts/b2_b7_phases.py [--out DIR] [--parent TREE]
                                    [--builds NAME,...]

B2 (`distance_argmin`) and B7 (`fuzzy_normalizer`) of the PyTorch/CUDA
port share one product, `tc_distance` in
tdc_tpu_torch/csrc/tc_distance.cuh: per 128-row block and 256-centroid K
tile the distance product on the tensor cores (3xTF32), x staged per K
tile and 32-column block by the product's own warps, then a fold in
registers (B2: the champion; B7: Σ inv and the champion), and per block
each row's champion scored again on the CUDA cores. The script runs,
each in its own process with its own build, these builds:

- full: the kernels as they are;
- no_fold: the folds replaced by a sum of the accumulators that keeps
  them live (the product, the x staging, B7's ‖x‖² and the per-row
  epilogue are left);
- no_restage: x staged in the first K tile of a block only (the later K
  tiles reuse whatever the buffers hold): what reading and splitting x
  again for every K tile costs;
- no_reload: x read in the first K tile of a block only, but split and
  stored in every K tile (stale values): the loads' part of that cost;
- no_rescore: B7 without the champion's f32 rescore (s = Σ inv as the
  tensor core gave it), checked only: the remedy for the truncating
  accumulation of the tensor core, read at m = 2 and m = 1.7;
- no_near_tie: B2's labels from the tensor core's values alone (no f32
  decision between the two best where they nearly tie), checked only:
  the 3xTF32 product must keep `far` = 0 on its own;
- one_tf32: the control: no_near_tie with the product as one TF32 pass
  (x_hi·c_hi only), checked only: on the near-tie inputs at d = 768 B2's
  labels must then differ from the plain version's beyond a near-tie
  (`far` > 0), which is what fails it in chip_smoke.py and the card
  tests;
- one_tf32_decided: the product as one TF32 pass with B2's f32 decision
  between the two best left in, checked only. On the two-candidate input
  its errors fall inside the decision's margin and its labels pass; on
  the three-candidate input (rows near the point equidistant from three
  centroids) one pass drops the nearest out of the two best, and `far`
  must be > 0 there while the full build keeps 0: what the two correction
  products buy;
- parent (with --parent TREE, the tdc_tpu_torch/ of an earlier commit,
  e.g. unpacked with `git archive <commit> tdc_tpu_torch`): as it is
  (before this design, B2 and B7 on the f32 FMA pipe).

Every build that times (`time`) runs B2 (`return_dist=True`) and B7 at
m = 2 and m = 1.7 at N=2^19, K=16,384, d=768 on chip_smoke.py's blobs,
and B2 at B1's shape (N=2^22, K=1024, d=128; the full build also B1):
what the product of tc_distance, which restages x every K tile, costs
beside B1, which stages x once a block;
the full and parent builds also time B2 and B7 with one 128-row block per
CTA (`one_block`: the pre-pass and one block's product, the fixed cost).
`checks` reports, per case, B2's labels that differ from the plain
version's (`near_ties`; `far` counts those beyond a near-tie: more than
1e-5 of ‖x‖² + max ‖c‖² in f64), the largest true gap among them as a
share of that limit (`gap_share`), on the near-tie inputs the rows whose
true gap lies past the limit and within ten times it (`past_limit`), the
largest error of B2's minima (both forms) and of B7's s (m = 2 and 1.7)
as a share of the card tolerance (1e-5 of ‖x‖² + max ‖c‖², 1e-5 of s),
and whether two runs are bitwise equal. Cases: the route's shape,
near-tie inputs at d = 768 and ragged ones (d = 19): points off the
point equidistant from two (`near_ties_*`) or three (`near_ties_3way_*`)
centroids by offsets log-uniform over 1e-6..10^-2.5 a coordinate
(chip_smoke.py's near_tie_data), K = 37 at d = 768 (the nearest centroid
carries a large share of s), and the card tests' edges; for B7 also rows
equal to centroids (`on_centroids_b7`: Σμ − N as a share of 1e-5·N,
which must stay ≤ 1). Each build also prints the registers
and spill stores/loads of its kernels (`nvcc -Xptxas -v`, when it built
them).

Each build is a copy of tdc_tpu_torch/ (and chip_smoke.py) under DIR
(default scratch_trees/b2_b7_phases, which .gitignore lists), timed with
CUDA events (median of 3 after a warm-up), in the order given (default:
full, no_fold, no_restage, no_reload, no_rescore, no_near_tie, one_tf32,
one_tf32_decided, then with --parent the parent, then full once more, times only;
scripts/_phases.py runs them).
The cut builds compute wrong answers; only their times (or, for the
checked ones, their errors) are read. Prints one JSON line per run, then
the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

HEADER = "csrc/tc_distance.cuh"

# The fold replaced by a sum of the accumulators into a store that never
# runs, so that they stay live: ptxas drops `wgmma`s whose results are
# never read.
FOLD = edit(HEADER, swaps=(("      tile(kt, acc);\n", """\
      (void)tile;
      float sink = 0.f;
#pragma unroll
      for (int e = 0; e < kTcBN / 2; ++e) sink += acc[e];
      if (sink == 1.2345f) sm.lab[0] = kt;
"""),))
RESTAGE = edit(HEADER, swaps=(
    ("        store_x_block(xa, xh, xl);\n",
     "        if (kt == 0) store_x_block(xa, xh, xl);\n"),
    ("        if (li + 2 < nxb) {\n", "        if (li + 2 < ncb) {\n")))
# x read from L2 in the first K tile of a block only; every K tile still
# splits and stores (stale values): the loads' share of the staging.
RELOAD = edit(HEADER, swaps=(
    ("        if (li + 2 < nxb) {\n", "        if (li + 2 < ncb) {\n"),))
RESCORE = edit("csrc/fuzzy_kernels.cu", swaps=((
    "              sr += (double)inv_power<kM2>(d2 + eps, p) - "
    "(double)sm.val[r];\n", ""),))
# B2's labels from the tensor core's values alone: no f32 decision where
# the two best nearly tie.
NEAR_TIE = edit("csrc/lloyd_kernels.cu", swaps=((
    "                            sm.val[r] <= kNearTie * (sc.xx + sc.cc + c2[jr]);\n",
    "                            sm.val[r] < 0.f;\n"),))
# The product as one TF32 pass: x_hi·c_hi only.
PRODUCT_ONE_TF32 = edit(HEADER, swaps=(
    ("          wgmma_m64n256k8_tf32(acc, sw128_desc(xl + 8 * kk), db, 1);\n",
     ""),
    ("        for (int kk = 0; kk < ks; ++kk) {\n"
     "          wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk),\n"
     "                               sw128_desc(cl + 8 * kk), 1);\n"
     "        }\n", "")))
ONE_TF32 = NEAR_TIE + PRODUCT_ONE_TF32

# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("time", "one_block", "checks")),
    "no_fold": ("repo", FOLD, ("time",)),
    "no_restage": ("repo", RESTAGE, ("time",)),
    "no_reload": ("repo", RELOAD, ("time",)),
    "no_rescore": ("repo", RESCORE, ("checks",)),
    "no_near_tie": ("repo", NEAR_TIE, ("checks",)),
    "one_tf32": ("repo", ONE_TF32, ("checks",)),
    "one_tf32_decided": ("repo", PRODUCT_ONE_TF32, ("checks",)),
    "parent": ("parent", (), ("time", "one_block", "checks")),
}

TIMER = r"""
import chip_smoke as cs
from tdc_tpu_torch.ops import _build, fuzzy_kernels as fk, lloyd_kernels as lk

SOURCES = ("lloyd_kernels.cu", "fuzzy_kernels.cu")
TIE_TOL, REL_TOL = 1e-5, 1e-5

def card_data(gen, n, k, d):
    # tests/test_torch_cuda.py's inputs
    centers = torch.rand((k, d), generator=gen, device="cuda") * 6 - 3
    lab = torch.arange(n, device="cuda") % k
    x = torch.randn((n, d), generator=gen, device="cuda") + centers[lab]
    return x.contiguous(), centers

def b2_reading(x, c, ways=0):
    lab, mn = lk.distance_argmin(x, c, return_dist=True)
    lab2, mn2 = lk.distance_argmin(x, c, return_dist=True)
    slab, smn = lk.distance_argmin(x, c)
    plab, pmn = lk.distance_argmin_plain(x, c, return_dist=True)
    pmn_s = lk.distance_argmin_plain(x, c)[1]
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    tol = REL_TOL * scale + 1e-6
    diff = (lab != plab).nonzero().flatten()
    far, gap_share = 0, 0.0
    if diff.numel():
        xd = x[diff].double()
        dg = ((xd - c[lab[diff].long()].double()) ** 2).sum(1)
        dw = ((xd - c[plab[diff].long()].double()) ** 2).sum(1)
        sc = (xd * xd).sum(1) + (c.double() ** 2).sum(1).max()
        share = (dg - dw).abs() / (TIE_TOL * sc)
        far, gap_share = int((share > 1).sum()), float(share.max())
    out = {"near_ties": int(diff.numel()), "far": far,
           "gap_share": gap_share,
           "min_share": float(((mn - pmn).abs() / tol).max()),
           "shifted_min_share": float(((smn - pmn_s).abs() / tol).max()),
           "forms_agree": bool(torch.equal(slab, lab)),
           "repeatable": bool(torch.equal(lab, lab2)
                              and torch.equal(mn, mn2))}
    if ways:
        out["past_limit"] = cs.tie_reach(x, c, ways)
    return out

def b7_reading(x, c):
    out = {}
    for m in (2.0, 1.7):
        s = fk.fuzzy_normalizer(x, c, m)
        want = fk.fuzzy_normalizer_plain(x, c, m)
        share = float(((s - want).abs() / (REL_TOL * want.abs() + 1e-6)
                       ).max())
        out[f"m{m}"] = {"s_share": share,
                        "repeatable": bool(torch.equal(
                            s, fk.fuzzy_normalizer(x, c, m)))}
    return out

t0 = time.perf_counter()
kl = _build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
# registers and spill stores/loads of B2's and B7's sources (when this
# process built them)
out["ptxas"] = [r[1:] for r in cs.ptxas_table(kl.log) if r[0] in SOURCES
                and ("argmin" in r[1] or "norm" in r[1])]
gen = torch.Generator(device="cuda").manual_seed(0)
n, k, d = cs.SORTED_N, cs.SORTED_K, cs.SORTED_D
x, c = cs.blob_data(gen, n, k, d)
if "time" in runs:
    out["b2_ms"] = median_ms(
        lambda: lk.distance_argmin(x, c, return_dist=True))
    for m in (2.0, 1.7):
        out[f"b7_m{m}_ms"] = median_ms(lambda: fk.fuzzy_normalizer(x, c, m))
if "time" in runs:
    # B2 at B1's shape (N=2^22, K=1024, d=128), and in the full build B1
    # itself: what the product of tc_distance, x restaged every K tile,
    # costs where B1 stages x once a block.
    x1, c1 = cs.blob_data(torch.Generator(device="cuda").manual_seed(1),
                          *cs.B1_SHAPE)
    out["b2_b1_shape_ms"] = median_ms(lambda: lk.distance_argmin(x1, c1))
    if build == "full":
        out["b1_ms"] = median_ms(lambda: lk.lloyd_stats_fused(x1, c1))
    del x1, c1
if "one_block" in runs:  # one 128-row block per CTA
    rows = 128 * torch.cuda.get_device_properties(0).multi_processor_count
    xs = x[:rows]
    out["b2_one_block_ms"] = median_ms(
        lambda: lk.distance_argmin(xs, c, return_dist=True))
    out["b7_one_block_ms"] = median_ms(lambda: fk.fuzzy_normalizer(xs, c))
print(json.dumps(out), flush=True)
if "checks" in runs:
    chk = {"route_b2": b2_reading(x, c), "route_b7": b7_reading(x, c)}
    del x, c
    for ways, tag in ((2, ""), (3, "3way_")):
        xs, cs_ = cs.near_tie_data(gen, 1 << 16, 1024, 768, ways)
        chk[f"near_ties_{tag}d768"] = b2_reading(xs, cs_, ways)
        xs, cs_ = cs.near_tie_data(gen, (1 << 16) + 37, 300, 19, ways)
        chk[f"near_ties_{tag}ragged"] = b2_reading(xs, cs_, ways)
    chk["on_centroids_b7"] = {f"m{m}": cs.on_centroids_share(gen, m)
                              for m in (2.0, 1.7)}
    for name, (n, k, d) in {"small_k_d768": ((1 << 16) + 37, 37, 768),
                            "ragged": ((1 << 16) + 37, 300, 19),
                            "1000x37x19": (1000, 37, 19),
                            "5000x130x128": (5000, 130, 128),
                            "3001x300x130": (3001, 300, 130),
                            "2000x70x769": (2000, 70, 769),
                            "777x257x768": (777, 257, 768),
                            "300x1x768": (300, 1, 768),
                            "129x1x1": (129, 1, 1)}.items():
        xs, cs_ = card_data(gen, n, k, d)
        chk[name] = {"b2": b2_reading(xs, cs_), "b7": b7_reading(xs, cs_)}
    print(json.dumps({"build": build, "checks": chk}), flush=True)
"""


if __name__ == "__main__":
    sys.exit(main("b2_b7_phases", BUILDS, TIMER,
                  ["full", "no_fold", "no_restage", "no_reload",
                   "no_rescore", "no_near_tie", "one_tf32",
                   "one_tf32_decided"],
                  ["parent"], reps=3))
