"""Where the time of B5 goes on one NVIDIA GPU, beside an earlier design.

    python3 scripts/b5_phases.py [--out DIR] [--parent TREE]
                                 [--builds NAME,...]

B5 is the bf16 tensor-core Lloyd stats kernel of the PyTorch/CUDA port
(`lloyd_stats_fused_bf16`, tdc_tpu_torch/csrc/lloyd_bf16_kernels.cu): per
128-row block the staging of x as bf16, the distance product on the
tensor cores, the champion fold, then the accumulate of the block's rows
into the CTA's workspace slice. The script runs, each in its own process
with its own build, these builds:

- full: the kernel as it is;
- no_accumulate: without the accumulate (the grouping of each block's
  rows by label, their sums, counts and SSE terms);
- no_fold: without the champion fold as well (no row gets a label);
- no_product: without the tensor-core product as well: the staging of x,
  the centroid stages' stream and the hand-over of the (empty) labels
  are left;
- acc_grouping and acc_no_x, probes of the accumulate: only its
  grouping of the rows by label (no workspace row is read, added or
  written), and everything but its reads of x;
- parent, parent_no_accumulate, parent_no_fold (with --parent TREE, the
  tdc_tpu_torch/ of an earlier commit, e.g. unpacked with `git archive
  <commit> tdc_tpu_torch`): the earlier design (`lloyd_bf16_kernel`,
  `nvcuda::wmma`, PRs 6-12) as it is, without its accumulate, and
  without its fold as well.

So for either design accumulate = full − no_accumulate (the full design
runs it beside the next block's product), fold = no_accumulate − no_fold,
and for the full design product = no_fold − no_product. Every build times
(`time`) B5 at N=2^22, K=1024, d=128 on chip_smoke.py's blobs, f32 and
bf16 rows. The full and parent builds also run `checks`: chip_smoke.py's
B5 check (labels equal to the plain version's but at near-ties in B5's
own metric, counts equal where they agree, sums within 1e-5 of Σ|x|, SSE
within 1e-5 relative, bitwise repeatable) at that shape and at the ragged
N=2^16+37, K=300, d=19, reporting the near-tie count, the sums' max
error and the largest share of a tolerance used, or the first failure.

Each build is a copy of tdc_tpu_torch/ and chip_smoke.py under DIR
(default scratch_trees/b5_phases, which .gitignore lists), timed with
CUDA events (median of 7 after a warm-up), in the order full,
no_accumulate, no_fold, no_product, acc_grouping, acc_no_x, then with
--parent the three parent builds, then full once more (times only). Each
run also prints the ptxas registers and spills of the source's kernels
(where it built them) and ptxas's warnings. The cut builds compute wrong
stats; only their times are read; --builds picks builds
(scripts/_phases.py runs them). Prints one JSON line per run, then the
card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

SOURCE = "csrc/lloyd_bf16_kernels.cu"

# The full design's cuts:
ACCUMULATE = edit(SOURCE, spans=(("      sse += accumulate_block<T, kVec>(",
                                  "      warp_arrive(&sm.freed[i & 1]);"),))
FOLD = edit(SOURCE, swaps=(("""\
          if (col < k && better(v0, col, best[h], barg[h])) {
            best[h] = v0;
            barg[h] = col;
          }
          if (col + 1 < k && better(v1, col + 1, best[h], barg[h])) {
            best[h] = v1;
            barg[h] = col + 1;
          }
""", "          (void)v0;\n          (void)v1;\n"),))
PRODUCT = edit(SOURCE, swaps=(("""\
          wgmma_m64n256k16_bf16(acc, sw128_desc(xa + 16 * kk),
                                sw128_desc(cs + 16 * kk), 1);
""", "          (void)xa;\n          (void)cs;\n"),))
# Probes of the accumulate: its grouping alone (no workspace row is
# read, added or written), and the accumulate without its reads of x.
ACC_GROUPING = edit(SOURCE, spans=(
    ("  for (int s0 = aw; s0 < nseg; s0 += kAccWarps * kSegsPerPass) {",
     "  named_barrier(3, kAccThreads);\n  double t = 0.0;"),))
ACC_NO_X = edit(SOURCE, swaps=(
    ("          xv[u] = C::load(x + (row0 + sm.order[p0[u]]) * d + j);",
     "          xv[u] = V{};"),
    ("          add(a[u], C::load(x + (row0 + sm.order[p]) * d + j));",
     "          add(a[u], xv[u]);")))
# The earlier design's (lloyd_bf16_kernel):
PARENT_ACCUMULATE = edit(SOURCE, spans=(
    ("    for (int j = tid; j < d; j += kThreads) {\n"
     "      for (int r0 = 0; r0 < rows; r0 += kGroup) {",
     "    if (tid == 0) {\n"
     "      for (int r = 0; r < rows; ++r) sse +="),))
PARENT_FOLD = edit(SOURCE, swaps=(("""\
          if (better(v, j, best, barg)) {
            best = v;
            barg = j;
          }
""", "          (void)v;\n"),))

# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("time", "checks")),
    "no_accumulate": ("repo", ACCUMULATE, ("time",)),
    "no_fold": ("repo", ACCUMULATE + FOLD, ("time",)),
    "no_product": ("repo", ACCUMULATE + FOLD + PRODUCT, ("time",)),
    "acc_grouping": ("repo", ACC_GROUPING, ("time",)),
    "acc_no_x": ("repo", ACC_NO_X, ("time",)),
    "parent": ("parent", (), ("time", "checks")),
    "parent_no_accumulate": ("parent", PARENT_ACCUMULATE, ("time",)),
    "parent_no_fold": ("parent", PARENT_ACCUMULATE + PARENT_FOLD,
                       ("time",)),
}

TIMER = r"""
SOURCE = "lloyd_bf16_kernels.cu"
import chip_smoke as cs
from tdc_tpu_torch.ops import _build, lloyd_kernels as lk

def reading(name, x, c):
    cs.TOL_SHARES.clear()
    try:
        err, ties = cs.check_b5(name, x, c)
    except AssertionError as e:
        return {"passes": False, "failure": str(e)}
    return {"passes": True, "near_ties": ties, "max_abs_err": err,
            "tol_share": max(cs.TOL_SHARES.values())}

t0 = time.perf_counter()
kl = _build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
# registers and spill stores/loads of the kernels of the source (when
# this process built them), and ptxas's warnings about them
out["ptxas"] = [r[1:] for r in cs.ptxas_table(kl.log) if r[0] == SOURCE]
out["ptxas_warnings"] = sorted({l.strip() for l in kl.log.splitlines()
                                if "arning" in l})
gen = torch.Generator(device="cuda").manual_seed(0)
n, k, d = cs.B1_SHAPE
x, c = cs.blob_data(gen, n, k, d)
for rows in (x, x.to(torch.bfloat16)):
    key = str(rows.dtype).removeprefix("torch.")
    if "time" in runs:
        out[f"{key}_ms"] = median_ms(lambda: lk.lloyd_stats_fused_bf16(rows, c))
    if "checks" in runs:
        out[f"{key}_checks"] = reading(f"B5 {key}", rows, c)
del x, c, rows
if "checks" in runs:
    x, c = cs.blob_data(gen, *cs.FUZZY_RAGGED)
    for rows in (x, x.to(torch.bfloat16)):
        key = str(rows.dtype).removeprefix("torch.")
        out[f"ragged_{key}_checks"] = reading(f"B5 ragged {key}", rows, c)
print(json.dumps(out), flush=True)
"""



if __name__ == "__main__":
    sys.exit(main("b5_phases", BUILDS, TIMER,
                  ["full", "no_accumulate", "no_fold", "no_product",
                   "acc_grouping", "acc_no_x"],
                  ["parent", "parent_no_accumulate", "parent_no_fold"],
                  reps=7))
