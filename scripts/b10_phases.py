"""Where the time of B10 goes on one NVIDIA GPU, beside the earlier design.

    python3 scripts/b10_phases.py [--out DIR] [--parent TREE]
                                  [--builds NAME,...]

B10 is the feature-major Lloyd stats kernel of the PyTorch/CUDA port
(`lloyd_stats_tall`, tdc_tpu_torch/csrc/tall_kernels.cu). At the tall
route's shape (N=10^8, K=15, d=5) its streaming form runs: a producer warp
streams 1536-column tiles of the columns into a ring of shared-memory
slots, and 12 consumer warps score each column against every centroid
(the distances and the running champion) and add it to its champion's row
of a per-thread accumulator (the accumulate); at K=16, d=8, 8 consumer
warps and 1024-column tiles. The script runs, each in its own process
with its own build, these builds:

- full: the kernel as it is;
- no_accumulate: without the accumulate (each column's label is added to
  one entry of the thread's accumulator instead, so the champion's
  selects stay live);
- loads_only: the consumers take the columns out of the ring and add Σx²
  to the SSE, nothing else: the rate this card's memory path gives for
  B10's bytes (the `stream_only` path of the kernel, always taken);
- no_distance: cross := 0, so v = ‖x‖² + ‖c‖² (no distance product; the
  champion's compare and selects and the accumulate stay);
- parent (with --parent TREE, the tdc_tpu_torch/ of an earlier commit,
  e.g. unpacked with `git archive <commit> tdc_tpu_torch`): the earlier
  kernel as it is (its private form, one thread a column and per-thread
  accumulators, below K·(d+1) = 96; its tile form past it).

So accumulate = full − no_accumulate, the distance product = full −
no_distance, and full − loads_only is what the arithmetic adds to the
memory path. Every build times (`time`) B10 at N=10^8, K=15, d=5 on
chip_smoke.py's feature-major blobs, on f32 and bf16 columns, and at
N=10^8, K=16, d=8 on f32 columns (past the earlier private form's limit:
the parent runs its tile form there). The full and parent builds run
`labels`: the labels of those three inputs; the full build writes them
under DIR, the parent build reads them and counts the labels that differ
(the streaming form keeps the earlier arithmetic, so 0 is the answer).

Each build is a copy of tdc_tpu_torch/ and chip_smoke.py under DIR
(default scratch_trees/b10_phases, which .gitignore lists), timed with
CUDA events (median of 15 after a warm-up), in the order full,
no_accumulate, loads_only, no_distance, then with --parent the parent
build, then full once more (times only); --builds picks builds. The cut
builds compute wrong stats; only their times are read (scripts/_phases.py
runs them). Each run also prints the ptxas registers and spills of the
B10 kernels (where it built them) and ptxas's warnings. Prints one JSON
line per run, then the card's name and power limit. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import sys

from _phases import edit, main

SOURCE = "csrc/tall_kernels.cu"

ACCUMULATE = edit(SOURCE, swaps=(("""\
  float* row = acc_t + a * ((kD + 1) * kThreads);
#pragma unroll
  for (int f = 0; f < kD; ++f) row[f * kThreads] += xc[f];
  reinterpret_cast<int*>(row)[kD * kThreads] += 1;
""", "  acc_t[0] += (float)a;\n"),))
LOADS_ONLY = edit(SOURCE, swaps=((
    "      if (stream_only) {  // [stream only]",
    "      if (true) {  // [stream only]"),))
NO_DISTANCE = edit(SOURCE, swaps=((
    "        cr[q][c] = fmaf(cv[q], x[c][f], cr[q][c]);",
    "        (void)cv;"),))

# name -> (root, cut, runs)
BUILDS = {
    "full": ("repo", (), ("time", "labels")),
    "no_accumulate": ("repo", ACCUMULATE, ("time",)),
    "loads_only": ("repo", LOADS_ONLY, ("time",)),
    "no_distance": ("repo", NO_DISTANCE, ("time",)),
    "parent": ("parent", (), ("time", "labels")),
}

TIMER = r"""
from pathlib import Path
import chip_smoke as cs
from tdc_tpu_torch.ops import _build, tall as tk

t0 = time.perf_counter()
kl = _build.load()
out = {"build": build, "build_s": time.perf_counter() - t0}
# registers and spill stores/loads of the B10 kernels (when this process
# built them), and ptxas's warnings
out["ptxas"] = [r[1:] for r in cs.ptxas_table(kl.log)
                if "tall_lloyd" in r[1]]
out["ptxas_warnings"] = sorted({l.strip() for l in kl.log.splitlines()
                                if "arning" in l})
shared = Path("..")  # the builds' common directory: the full build's labels
gen = torch.Generator(device="cuda").manual_seed(0)
for n, k, d in (cs.TALL_SHAPE, (10 ** 8, 16, 8)):
    xt, c = cs.tall_blobs(gen, n, k, d)
    for cols in ((xt, xt.to(torch.bfloat16)) if d == 5 else (xt,)):
        key = f"{str(cols.dtype).removeprefix('torch.')}_k{k}_d{d}"
        if "time" in runs:
            out[f"{key}_ms"] = median_ms(lambda: tk.lloyd_stats_tall(cols, c))
        if "labels" in runs:
            lab = tk.lloyd_stats_tall(cols, c, return_labels=True)[1]
            lab = lab.to(torch.uint8)
            path = shared / f"labels_{key}.pt"
            if build == "full":
                torch.save(lab.cpu(), path)
            else:
                full = torch.load(path).cuda()
                out[f"{key}_labels_differ_from_full"] = int(
                    (full != lab).sum())
        del cols
    del xt, c
print(json.dumps(out), flush=True)
"""


if __name__ == "__main__":
    sys.exit(main("b10_phases", BUILDS, TIMER,
                  ["full", "no_accumulate", "loads_only", "no_distance"],
                  ["parent"], reps=15))
