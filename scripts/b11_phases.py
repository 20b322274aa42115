"""Where the time of B11 goes on one NVIDIA GPU, beside an earlier design.

    python3 scripts/b11_phases.py [--out DIR] [--parent TREE]
                                  [--builds NAME,...]

B11 is the feature-major fuzzy stats kernel of the PyTorch/CUDA port
(`fuzzy_stats_tall`, tdc_tpu_torch/csrc/tall_kernels.cu). At the tall
fuzzy route's shape (N=10^8, K=15, d=5) its private form runs: per column
the distances to every centroid and s = Σ inv (pass 1), then the
memberships μ = (inv / s)^m and the accumulate of Σμx and Σμ (pass 2).
The script runs, each in its own process with its own build, these
builds:

- full: the kernel as it is (the accumulate as a μᵀ·X product on the
  tensor cores);
- no_accumulate: without the accumulate (μ and the columns are not
  written to the warp's tiles, no product);
- no_powers: μ := inv (no power of inv / s);
- no_inv: at m = 2, inv := v (no 1/v);
- no_distance: d² := ‖x‖² + ‖c‖² (no distance product);
- one_tf32: the control: μᵀ·X as one TF32 pass (μ_hi·x_hi, the two
  correction products dropped), checked only: its Σμx must fail the
  small-N check below, which is what fails it in chip_smoke.py and the
  card tests;
- parent, parent_no_accumulate, parent_no_powers (with --parent TREE,
  the tdc_tpu_torch/ of an earlier commit, e.g. unpacked with `git
  archive <commit> tdc_tpu_torch`): the earlier private form (per-thread
  (K, d+1) accumulators in shared memory, PR 7) as it is, without its
  read-modify-writes of them, and with μ := inv.

So accumulate = full − no_accumulate and powers = full − no_powers for
either design, and 1/v = full − no_inv and the distances = full −
no_distance at m = 2. Every build times (`time`) B11 at N=10^8, K=15,
d=5 on chip_smoke.py's feature-major blobs: f32 columns at m=2 and
m=1.7, bf16 columns at m=2. The full, one_tf32 and parent builds run
`checks`: chip_smoke.py's B11 check (bitwise repeatable, Σμx within 1e-5
of Σμ|x|, Σμ and the objective within 1e-5 relative) on f32 and bf16
columns at m=2 and 1.7, at that shape and at chip_smoke.py's TALL_SMALL
(N=1000: too few columns for one TF32 pass's rounding to average out),
reporting the sums' max error and the largest share of a tolerance used,
or the first failure.

Each build is a copy of tdc_tpu_torch/ and chip_smoke.py under DIR
(default scratch_trees/b11_phases, which .gitignore lists), timed with
CUDA events (median of 7 after a warm-up), in the order full,
no_accumulate, no_powers, no_inv, no_distance, one_tf32, then with
--parent the three parent builds, then full once more (times only);
--builds picks builds. The cut builds compute wrong stats; only their
times and check readings are read (scripts/_phases.py runs them). Each run also prints
the ptxas registers and spills of the B11 kernels (where it built them)
and ptxas's warnings. Prints one JSON line per run, then the card's name
and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

SOURCE = "csrc/tall_kernels.cu"

# The full design's cuts:
ACCUMULATE = edit(SOURCE, spans=(
    ("    {  // the column's features",
     "    if (live) obj += (double)ob;\n    __syncwarp();"),
    ("    // μᵀ·X over the warp's 32 columns",
     "    __syncwarp();  // the tiles are free")), swaps=(("""\
        *reinterpret_cast<float4*>(mrow + kg + q) =
            make_float4(mu[q], mu[q + 1], mu[q + 2], mu[q + 3]);
""", "        (void)mrow;\n"),))
POWERS = edit(SOURCE, swaps=((
    "          mu[q] = fuzzy_mu<kM2>(w[q], rs, ls, mexp);",
    "          mu[q] = fuzzy_inv<kM2>(w[q]);"),))
# Pass 1's parts: 1/v at m = 2 (inv := v), and the distance product (d²
# := ‖x‖² + ‖c‖², no centroid is read).
NO_INV = edit(SOURCE, swaps=(("  return kM2 ? 1.f / v : p * log2f(v);",
                              "  return kM2 ? v : p * log2f(v);"),))
NO_DISTANCE = edit(SOURCE, swaps=(("""\
    if (f < d) {
      const float4* row = reinterpret_cast<const float4*>(cs + f * kp + kg);""",
                                   """\
    if (f < 0) {
      const float4* row = reinterpret_cast<const float4*>(cs + f * kp + kg);"""
                                   ),))
# The control: μᵀ·X as one TF32 pass (μ_hi·x_hi; the lo·hi and hi·lo
# products dropped).
ONE_TF32 = edit(SOURCE, swaps=(("""\
          mma_tf32(acc[0], al, bh[0], bh[1]);
          if (!kExactX) mma_tf32(acc[1], ah, bl[0], bl[1]);
""", "          (void)al;\n          (void)bl;\n"),))
# The earlier design's:
PARENT_ACCUMULATE = edit(SOURCE, swaps=(("""\
          float* row = acc + j * d1 * kCols + t;
#pragma unroll
          for (int f = 0; f < kDR; ++f) {
            if (f < d) row[f * kCols] = fmaf(mu, x0[f], row[f * kCols]);
          }
          row[d * kCols] += mu;
""", ""),))
PARENT_POWERS = edit(SOURCE, swaps=((
    "          const float mu = mu_power<kM2>(iv[q] / s, mexp);",
    "          const float mu = iv[q];"),))

# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("time", "checks")),
    "no_accumulate": ("repo", ACCUMULATE, ("time",)),
    "no_powers": ("repo", POWERS, ("time",)),
    "no_inv": ("repo", NO_INV, ("time",)),
    "no_distance": ("repo", NO_DISTANCE, ("time",)),
    "one_tf32": ("repo", ONE_TF32, ("checks",)),
    "parent": ("parent", (), ("time", "checks")),
    "parent_no_accumulate": ("parent", PARENT_ACCUMULATE, ("time",)),
    "parent_no_powers": ("parent", PARENT_POWERS, ("time",)),
}

TIMER = r"""
import chip_smoke as cs
from tdc_tpu_torch.ops import _build, tall as tk

def reading(name, xt, c, m):
    cs.TOL_SHARES.clear()
    try:
        err = cs.check_tall_fuzzy(name, xt, c, m)
    except AssertionError as e:
        return {"passes": False, "failure": str(e)}
    return {"passes": True, "max_abs_err": err,
            "tol_share": max(cs.TOL_SHARES.values())}

t0 = time.perf_counter()
kl = _build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
# registers and spill stores/loads of the B11 kernels (when this process
# built them), and ptxas's warnings
out["ptxas"] = [r[1:] for r in cs.ptxas_table(kl.log)
                if "tall_fuzzy" in r[1]]
out["ptxas_warnings"] = sorted({l.strip() for l in kl.log.splitlines()
                                if "arning" in l})
gen = torch.Generator(device="cuda").manual_seed(0)
xt, c = cs.tall_blobs(gen, *cs.TALL_SHAPE)
for cols in (xt, xt.to(torch.bfloat16)):
    key = str(cols.dtype).removeprefix("torch.")
    for m in cs.FUZZY_MS:
        if "time" in runs and (m == 2.0 or cols.dtype == torch.float32):
            out[f"{key}_m{m}_ms"] = median_ms(
                lambda: tk.fuzzy_stats_tall(cols, c, m))
        if "checks" in runs:
            out[f"{key}_m{m}_checks"] = reading(f"B11 {key} m={m}", cols, c,
                                                m)
    del cols
del xt, c
if "checks" in runs:  # the small N, where one TF32 pass shows
    xt, c = cs.tall_blobs(gen, *cs.TALL_SMALL)
    for cols in (xt, xt.to(torch.bfloat16)):
        key = str(cols.dtype).removeprefix("torch.")
        for m in cs.FUZZY_MS:
            out[f"small_{key}_m{m}_checks"] = reading(
                f"B11 small {key} m={m}", cols, c, m)
print(json.dumps(out), flush=True)
"""


if __name__ == "__main__":
    sys.exit(main("b11_phases", BUILDS, TIMER,
                  ["full", "no_accumulate", "no_powers", "no_inv",
                   "no_distance", "one_tf32"],
                  ["parent", "parent_no_accumulate", "parent_no_powers"],
                  reps=7))
