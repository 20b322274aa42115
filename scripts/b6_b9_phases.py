"""Where the time of B6's and B9's phase 2 goes on one NVIDIA GPU, what
their 3xTF32 split buys in accuracy, and how they fare past the fuzzy and
GMM routes' shape.

    python3 scripts/b6_b9_phases.py [--out DIR] [--parent TREE]
                                    [--builds NAME,...]

B6 (fuzzy stats) and B9 (the diag-GMM E-step) of the PyTorch/CUDA port
run their phase 2 on the tensor cores (tdc_tpu_torch/csrc/tf32_accum.cuh,
B9's phase 1 too: csrc/gmm_kernels.cu): stage a step of weights and x in
shared memory, then the 3xTF32 product wᵀ·X. The script runs, each in
its own process with its own build, the kernels in these builds:

- full: the kernels as they are;
- one_tf32: only the hi·hi′ product of the three, in every 3xTF32
  product (a plain TF32 product: what the split costs is full −
  one_tf32);
- no_mma: no product in phase 2 at all (the staging, the weights' exps or
  powers, the Σw sums and the loads are left);
- parent: with --parent TREE, the tdc_tpu_torch/ of an earlier commit
  (e.g. unpacked with `git archive <commit> tdc_tpu_torch`), as it is.

What each build runs:

- phase2 (full, one_tf32, no_mma): phase 2 alone
  (`_launch(..., phases=2)`, on the scratch phase 1 left) at N=2^22,
  K=1024, d=128, B6 at m=2 and m=1.7;
- checks (full, one_tf32, parent): chip_smoke.py's checks of B6 (m=2,
  1.7) and B9 against their plain versions (bitwise repeatable; sums
  within 1e-5 of Σμ|x| or Σr|x|, the rest 1e-5 relative) at the routes'
  shape and at the ragged N=2^16+37, K=300, d=19 (B9 also with the
  variances 30x wider, "ragged soft"): the max abs error of the sums and
  the largest share of a tolerance used where the check passes, the
  first failure's message where it fails;
- wide (full, parent): B6 (m=2) and B9 at shapes past the routes' (d =
  256 at K=1024; K=16,384 at d = 128 and 768), and in the full build
  B6's design before PR 11 (B7's kernel then B8's, `fuzzy_stats_twopass`)
  beside it.

Each build is a copy of tdc_tpu_torch/ and chip_smoke.py under DIR
(default scratch_trees/b6_b9_phases, which .gitignore lists), timed with
CUDA events (median of 5 after a warm-up; 3 at the wide shapes), in the
order full, one_tf32, no_mma, parent, full (the last time only phase2
and wide); --builds picks builds (scripts/_phases.py runs them). The cut
builds compute wrong stats; only their times and check readings are
read. Prints one JSON line
per run, then the card's name and power limit. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

# The two small products of the split, in phase 2 (tf32_accum.cuh) and in
# B9's phase 1 (gmm_kernels.cu), and phase 2's large one.
SMALL = {
    "csrc/tf32_accum.cuh": (
        "        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], "
        "bh[j][0], bh[j][1]);\n",
        "        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], "
        "bl[j][0], bl[j][1]);\n"),
    "csrc/gmm_kernels.cu": (
        "      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], "
        "bh[j][0], bh[j][1]);\n",
        "      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], "
        "bl[j][0], bl[j][1]);\n"),
}
LARGE = {"csrc/tf32_accum.cuh": (
    "        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], "
    "bh[j][0], bh[j][1]);\n",)}



def no_product(lines: dict) -> tuple:
    """The cut that leaves an empty loop in place of each product line."""
    return sum((edit(source, swaps=[
        (line, line[:len(line) - len(line.lstrip())]
         + "for (int j = 0; j < 4; ++j) {}\n") for line in cuts])
        for source, cuts in lines.items()), ())


# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("phase2", "checks", "wide")),
    "one_tf32": ("repo", no_product(SMALL), ("phase2", "checks")),
    "no_mma": ("repo", no_product(
        {"csrc/tf32_accum.cuh": (*SMALL["csrc/tf32_accum.cuh"],
                                 *LARGE["csrc/tf32_accum.cuh"])}),
               ("phase2",)),
    "parent": ("parent", (), ("checks", "wide")),
}

TIMER = r"""
import chip_smoke as cs
from tdc_tpu_torch.models import gmm as gm
from tdc_tpu_torch.ops import _build, fuzzy_kernels as fk, gmm_kernels as gk

def reading(check, name, *args):
    cs.TOL_SHARES.clear()
    try:
        err = check(name, *args)
    except AssertionError as e:
        return {"passes": False, "failure": str(e)}
    return {"passes": True, "max_abs_err": err,
            "tol_share": max(cs.TOL_SHARES.values())}

t0 = time.perf_counter()
_build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
gen = torch.Generator(device="cuda").manual_seed(0)
n, k, d = cs.B1_SHAPE
x, c = cs.blob_data(gen, n, k, d)
var, w = gm._moments_from_hard_assign(x, c, 1e-6)
c2 = (c * c).sum(dim=1)
if "phase2" in runs:
    ops = gk._operands(c, var, w)
    gk._launch(x, *ops, phases=1)
    out["b9_phase2_ms"] = median_ms(lambda: gk._launch(x, *ops, phases=2))
    for m in cs.FUZZY_MS:
        fk._launch(x, c, c2, m, 1e-9, phases=1)
        out[f"b6_m{m}_phase2_ms"] = median_ms(
            lambda: fk._launch(x, c, c2, m, 1e-9, phases=2))
if "checks" in runs:
    chk = {"b9": reading(cs.check_gmm, "B9", x, c, var, w)}
    for m in cs.FUZZY_MS:
        chk[f"b6_m{m}"] = reading(cs.check_fuzzy, f"B6 m={m}", x, c, m)
    rn, rk, rd = cs.FUZZY_RAGGED
    xr, cr = cs.blob_data(gen, rn, rk, rd)
    vr, wr = gm._moments_from_hard_assign(xr, cr, 1e-6)
    for name, scale in (("ragged", 1.0), ("ragged_soft", 30.0)):
        chk[f"b9_{name}"] = reading(cs.check_gmm, f"B9 {name}", xr, cr,
                                    vr * scale, wr)
    for m in cs.FUZZY_MS:
        chk[f"b6_ragged_m{m}"] = reading(cs.check_fuzzy, f"B6 ragged m={m}",
                                         xr, cr, m)
    out["checks"] = chk
    del xr, cr, vr, wr
del x, c, var, w, c2
if "wide" in runs:
    wide = {}
    for n, k, d in ((1 << 22, 1024, 256), (1 << 20, 16384, 128),
                    (1 << 19, 16384, 768)):
        x, c = cs.blob_data(gen, n, k, d)
        var = torch.ones_like(c)
        w = torch.full((k,), 1.0 / k, device="cuda")
        row = {"b6_ms": median_ms(lambda: fk.fuzzy_stats_fused(x, c, 2.0),
                                  3),
               "b9_ms": median_ms(lambda: gk.gmm_stats_fused(x, c, var, w),
                                  3)}
        if build != "parent":
            row["b6_twopass_ms"] = median_ms(
                lambda: fk.fuzzy_stats_twopass(x, c, 2.0), 3)
        wide[f"N={n} K={k} d={d}"] = row
        del x, c, var, w
        torch.cuda.empty_cache()
    out["wide"] = wide
print(json.dumps(out), flush=True)
"""



if __name__ == "__main__":
    sys.exit(main("b6_b9_phases", BUILDS, TIMER,
                  ["full", "one_tf32", "no_mma"], ["parent"], reps=5,
                  repeat_runs=("phase2", "wide")))
